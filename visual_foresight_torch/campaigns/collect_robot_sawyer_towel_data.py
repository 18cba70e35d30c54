"""Sawyer towel-folding collection, on the port.

The twin of ``data_collection/sawyer/towel_data/hparams.py``: the same keys
and values (the scripted ``RandomFoldPolicy``, five cameras at 240x320, T
21) and the same ``VMPC_*`` overrides, with the port's classes.  Its
experiment directory is
``campaigns/runs/collect_robot_sawyer_towel_data/``.

The arm and its cameras run on the robot's host; the policy draws on the
host: nothing here runs on the card.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        collect_robot_sawyer_towel_data.py <robot>
"""

import os

import numpy as np

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.random.random_fold_policy import (
    RandomFoldPolicy)

if 'VMPC_DATA_DIR' in os.environ:
    BASE_DIR = os.path.join(os.environ['VMPC_DATA_DIR'], 'towel_pick/')
else:
    BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                            'collect_robot_sawyer_towel_data')
current_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                           'collect_robot_sawyer_towel_data')

env_params = {
    'robot_name': 'sawyer',
    'lower_bound_delta': [0, 0., -0.01, 265 * np.pi / 180 - np.pi / 2, 0],
    'upper_bound_delta': [0, -0.15, -0.01, 0., 0],
    'normalize_actions': True,
    'gripper_joint_thresh': 0.999856,
    'rand_drop_reset': False,
    'camera_topics': [IMTopic('/front/image_raw', flip=True),
                      IMTopic('/left/image_raw'),
                      IMTopic('/right_side/image_raw'),
                      IMTopic('/left_side/image_raw'),
                      IMTopic('/right/image_raw')],
    'zthresh': 0.05,   # gripper only closes very close to the table
}

agent = {
    'type': GeneralAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 21,
    'image_height': 240,
    'image_width': 320,
}

policy = {
    'type': RandomFoldPolicy,
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 120000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
