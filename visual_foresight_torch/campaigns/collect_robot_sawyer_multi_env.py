"""Sawyer collection shared by two stations, on the port.

The twin of ``data_collection/sawyer/multi_env/hparams.py``: the same keys
and values (per-robot ``override_nordri`` and ``override_vestri`` blocks, a
``GaussianPolicy`` of 10 actions, 240x320, T 30) and the same ``VMPC_*``
overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/collect_robot_sawyer_multi_env/``.

The arm and its cameras run on the robot's host; the policy draws on the
host: nothing here runs on the card.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        collect_robot_sawyer_multi_env.py <robot>
"""

import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_robot_sawyer_multi_env')
current_dir = BASE_DIR

conditional_override_nordri = {
    'env_params': {
        'camera_topics': [IMTopic('/kinect2/hd/image_color', left=150,
                                  right=200, bot=250, flip=True),
                          IMTopic('/camera/image_raw')],
        'upper_bound_delta': [0., 0., -0.036, 0., 0.],
        'lower_bound_delta': [0., 0., -0.036, 0., 0.],
    }
}

conditional_override_vestri = {
    'env_params': {
        'upper_bound_delta': [0., 0., 0.047, 0., 0.],
        'lower_bound_delta': [0., 0., 0.047, 0., 0.],
        'gripper_attached': 'none',
    }
}

agent = {
    'type': GeneralAgent,
    'env': (AutograspEnv, {'robot_name': 'sawyer'}),
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
    'override_nordri': conditional_override_nordri,
    'override_vestri': conditional_override_vestri,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 120000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
    'mode': 'test',
}
