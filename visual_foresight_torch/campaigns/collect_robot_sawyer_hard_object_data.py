"""Sawyer autograsp collection over rigid objects, on the port.

The twin of ``data_collection/sawyer/hard_object_data/hparams.py``: the
same keys and values (a widened x workspace, a ``GaussianPolicy`` of 10
actions, the env's default cameras at 240x320, T 30) and the same
``VMPC_*`` overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/collect_robot_sawyer_hard_object_data/``.

The arm and its cameras run on the robot's host; the policy draws on the
host: nothing here runs on the card.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        collect_robot_sawyer_hard_object_data.py <robot>
"""

import os

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

if 'VMPC_DATA_DIR' in os.environ:
    BASE_DIR = os.path.join(os.environ['VMPC_DATA_DIR'], 'towel_pick/')
else:
    BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                            'collect_robot_sawyer_hard_object_data')
current_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                           'collect_robot_sawyer_hard_object_data')

env_params = {
    'robot_name': 'sawyer',
    'upper_bound_delta': [0.07, 0., 0., 0., 0.],
}

agent = {
    'type': GeneralAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 240,
    'image_width': 320,
    'record': BASE_DIR + '/record/',
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'initial_std': 0.035,
    'initial_std_lift': 0.08,
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
