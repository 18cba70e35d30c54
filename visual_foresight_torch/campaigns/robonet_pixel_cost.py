"""RoboNet pixel-cost benchmark on the sawyer, on the port.

The twin of ``experiments/robonet/pixel_cost/hparams.py``: the same keys
and values (the Gaussian sampler: 600 samples of 13 actions (repeat 1), 3
iterations, one replan over the 13 steps, ``predictor_propagation``, one
camera) and the same ``VMPC_*`` overrides, with the port's classes.  Its
experiment directory is ``campaigns/runs/robonet_pixel_cost/``.

The repo holds no model of this experiment: without ``VMPC_MODEL_DIR`` the
predictor is the numpy export ``weights/ag_r5f_v2`` (``adim`` 4, ``sdim``
5; ``stand_ins.py``, which warns).

As written the policy plans only in the host CEM loop: 13 actions x repeat
1 under the controller's default ``T`` of 15 stop the fused planner, which
needs ``nactions * repeat == T``, so the controller raises ``ValueError``
in the port (``AssertionError`` in the JAX package). Set
``policy['use_fused_planner'] = False`` in a copy of this config to run it.

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robonet_pixel_cost.py <robot> --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.cem_controllers.pixel_cost_controller import (  # noqa: E501
    PixelCostController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robonet_pixel_cost')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'start_box': [1, 1, 0.7],
    'reset_before_eval': False,
    'rand_drop_reset': False,
    'save_video': True,
    'camera_topics': [IMTopic('/test/image_raw')],
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 13,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'make_final_recording': '',
}

policy = {
    'type': PixelCostController,
    'replan_interval': 13,
    'num_samples': 600,
    'selection_frac': 0.05,
    'predictor_propagation': True,
    'initial_std_lift': 0.2,
    'initial_std_rot': np.pi / 10,
    'rejection_sampling': False,
    'nactions': 13,
    'repeat': 1,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'robonet/pixel_cost/modeldata'),
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
