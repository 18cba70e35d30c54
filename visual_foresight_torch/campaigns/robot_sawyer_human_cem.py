"""Human-in-the-loop CEM on the two-camera sawyer, on the port.

The twin of ``experiments/sawyer/human_cem/hparams.py``: the same keys and
values (a person scores the candidate plans of each iteration
(``HumanCEMController``: 50 samples, 5 actions x repeat 3, 3 iterations, a
replan every 10 of the 30 steps, two cameras)) and the same ``VMPC_*``
overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/robot_sawyer_human_cem/``.

The repo holds no sawyer model: without ``VMPC_MODEL_DIR`` the two-view
predictor is the numpy export ``weights/ag_r5f_v2`` (``adim`` 4, ``sdim``
5) and it plus seeded noise (seed 91), written once under
``build/stand_ins/`` (``stand_ins.py``, which warns).

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robot_sawyer_human_cem.py <robot> --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.cem_controllers.human_cem_controller import (  # noqa: E501
    HumanCEMController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robot_sawyer_human_cem')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'lower_bound_delta': [0, 0., -0.01, 265 * np.pi / 180 - np.pi / 2, 0],
    'upper_bound_delta': [0, -0.15, -0.01, 0., 0],
    'start_box': [1, 1, 0.7],
    'normalize_actions': True,
    'gripper_joint_thresh': 0.999856,
    'reset_before_eval': False,
    'rand_drop_reset': False,
    'save_video': True,
    'camera_topics': [IMTopic('/front/image_raw', flip=True),
                      IMTopic('/left/image_raw')],
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'make_final_recording': '',
    'no_goal_def': '',
}

policy = {
    'type': HumanCEMController,
    'replan_interval': 10,
    'num_samples': 50,
    'selection_frac': 0.1,
    'initial_std_lift': 0.2,
    'initial_std_rot': np.pi / 10,
    'rejection_sampling': False,
    'state_append': [0.41, 0.25, 0.166],
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.second_view(
        'ag_r5f_v2', 91, 'sawyer/human_cem/modeldata'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 30000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
    'nshuffle': 200,
}
