"""The two-camera sawyer pixel-cost experiment on the port.

The twin of ``experiments/sawyer/pixel_cost/hparams.py``: the same keys and
values, with the port's classes (``BenchmarkAgent``, the robot
``AutograspEnv``, two ``IMTopic`` cameras and ``PixelCostController``: 600
samples of 5 actions x repeat 3, 3 iterations, a replan every 10 of the
20 steps, ``predictor_propagation``).  ``state_append`` stays as the source
writes it; neither controller reads it.

Weights: ``VMPC_MODEL_DIR``, as in the source.  The repo holds no sawyer
model, and a run needs a two-view directory: ``view0/`` and ``view1/``
(each a ``params.npz`` or a TF1 bundle) and a ``model_config.json`` of a
predictor with ``adim`` 4 and ``sdim`` 5, for example
``visual_foresight_torch/weights/ag_r5f_v2`` for ``view0/`` and a second
view beside it.  A view without weights raises in the smoke run; the
controller's ``restored`` flag says so elsewhere.

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS::

    python -m visual_foresight_torch.sim.run_robot \\
        visual_foresight_torch/campaigns/robot_sawyer_pixel_cost.py sawyer \\
        --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.cem_controllers import PixelCostController

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robot_sawyer_pixel_cost')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'lower_bound_delta': [0, 0., 0.008, 0., 0],
    'upper_bound_delta': [0, 0., 0.008, 0., 0],
    'start_box': [1, 1, 0.7],
    'normalize_actions': True,
    'gripper_joint_thresh': 0.999856,
    'reset_before_eval': False,
    'rand_drop_reset': False,
    'save_video': True,
    'camera_topics': [IMTopic('/camera0/image_raw', flip=True),
                      IMTopic('/camera1/image_raw')],
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 20,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'make_final_recording': '',
}

policy = {
    'type': PixelCostController,
    'replan_interval': 10,
    'num_samples': 600,
    'selection_frac': 0.05,
    'predictor_propagation': True,   # propagate desig. pixel via the model
    'initial_std_lift': 0.2,
    'initial_std_rot': np.pi / 10,
    'rejection_sampling': False,
    'state_append': [0.41, 0.4, 0.184],
    'model_path': os.environ.get('VMPC_MODEL_DIR', BASE_DIR + '/modeldata'),
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
