"""Random end-effector exploration with the rendered 7-DoF Sawyer arm in
the bin arena, on the port.

The twin of ``data_collection/sim/sawyer_arm/hparams.py``: the same keys
and values (two cube objects, T 15, 48x64 frames from 96x128 renders, a
``GaussianPolicy`` of 5 actions over (dx, dy, dz, dyaw, grip), 16
trajectories a file), with the port's classes; the data go to
``VMPC_DATA_DIR``, or without it under
``campaigns/runs/collect_sawyer_arm/data``.  MuJoCo renders on the host
and the policy draws on the host: nothing here runs on the card.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/collect_sawyer_arm.py [--nworkers N]
"""

import os

import numpy as np

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.sawyer_env.sawyer_arm_env import (
    SawyerArmEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sawyer_arm')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')

env_params = {
    'num_objects': 2,
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': GeneralAgent,
    'env': (SawyerArmEnv, env_params),
    'data_save_dir': DATA_DIR,
    'T': 15,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 200,
}

policy = {
    'type': GaussianPolicy,
    'nactions': 5,
    # (dx, dy, dz, dyaw, grip)
    'initial_std': 0.04,
    'initial_std_lift': 0.08,
    'initial_std_rot': np.pi / 16,
}

config = {
    'traj_per_file': 16,
    'current_dir': BASE_DIR,
    'save_data': True,
    'start_index': 0,
    'end_index': 1000,
    'agent': agent,
    'policy': policy,
}
