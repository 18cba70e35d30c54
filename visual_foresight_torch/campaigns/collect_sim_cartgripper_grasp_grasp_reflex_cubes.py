"""Autograsp collection over 12 cubes with rejection-sampled grasps, on the
port.

The twin of
``data_collection/sim/cartgripper_grasp/grasp_reflex_cubes/hparams.py``:
the same keys and values (T 30, 48x64 frames, a ``GaussianPolicy`` of 10
actions, fresh scenes every 400 trajectories, good and bad trajectories
apart) and the same ``VMPC_*`` overrides, with the port's classes.  Its
experiment directory is
``campaigns/runs/collect_sim_cartgripper_grasp_grasp_reflex_cubes/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_grasp_grasp_reflex_cubes.py [--nworkers N]
"""

import os.path

import numpy as np

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_grasp_grasp_reflex_cubes')
current_dir = BASE_DIR

env_params = {
    'num_objects': 12,
    'object_mass': 0.5,
    'friction': 1.0,
    'finger_sensors': True,
    'minlen': 0.03,
    'maxlen': 0.06,
    'object_object_mindist': 0.15,
    'cube_objects': True,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': GeneralAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 400,      # fresh scene XML every nth trajectory
    'rejection_sample': 5,
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'initial_std': 0.04,
    'initial_std_lift': 0.6,
    'initial_std_rot': np.pi / 32,
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'seperate_good': True,
    'save_raw_images': False,
    'start_index': 30000,
    'end_index': 60000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
