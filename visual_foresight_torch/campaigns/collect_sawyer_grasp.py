"""Random grasp collection in the Sawyer workspace, on the port.

The twin of ``data_collection/sim/sawyer_grasp/hparams.py``: the same keys
and values (``SawyerEnv``, the MuJoCo-native workspace env, with six
objects; T 30, 48x64 frames, a ``GaussianPolicy`` of 10 actions, good and
bad trajectories apart, raw images kept, indices 30000-60000), with the
port's classes; the data go to ``VMPC_DATA_DIR``, or without it under
``campaigns/runs/collect_sawyer_grasp/data``.  MuJoCo renders on the host
and the policy draws on the host: nothing here runs on the card.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/collect_sawyer_grasp.py \\
        [--nworkers N]
"""

import os

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.sawyer_env.base_sawyer_env import (
    SawyerEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sawyer_grasp')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')

env_params = {
    'num_objects': 6,
}

agent = {
    'type': GeneralAgent,
    'env': (SawyerEnv, env_params),
    'data_save_dir': DATA_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 400,
    'make_final_gif': '',
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'initial_std': 0.04,
    'initial_std_lift': 0.6,
}

config = {
    'traj_per_file': 128,
    'current_dir': BASE_DIR,
    'save_data': True,
    'seperate_good': True,
    'save_raw_images': True,
    'start_index': 30000,
    'end_index': 60000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
