"""Kuka four-camera autograsp collection, on the port.

The twin of ``data_collection/kuka/3_View/hparams.py``: the same keys and
values (a ``GaussianPolicy`` of 30 actions, four USB cameras at 240x320, T
30) and the same ``VMPC_*`` overrides, with the port's classes.  Its
experiment directory is ``campaigns/runs/collect_robot_kuka_3_view/``.

The arm and its cameras run on the robot's host; the policy draws on the
host: nothing here runs on the card.

Run on a machine with the arm, its cameras and ROS::

    python -m visual_foresight_torch.sim.run_robot \\
        visual_foresight_torch/campaigns/collect_robot_kuka_3_view.py <robot>
"""

import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_robot_kuka_3_view')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'kuka',
    'robot_type': 'kuka',
    'gripper_attached': 'kuka_gripper',
    'email_login_creds': '.email_cred',
    'camera_topics': [IMTopic('/camera1/usb_cam/image_raw'),
                      IMTopic('/camera2/usb_cam/image_raw'),
                      IMTopic('/camera3/usb_cam/image_raw'),
                      IMTopic('/camera4/usb_cam/image_raw')],
    'print_debug': True,
    'duration': 4,
    'OFFSET_TOL': 0.5,
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
    'nactions': 30,
    'repeat': 1,
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
