"""Two-task rigid-object MPC with the folding prior and pixel propagation on
the sawyer, on the port.

The twin of ``experiments/sawyer/mixed_objects/hparams_hardobjects.py``:
the same keys and values (``PixelCostController`` with
``FoldingCEMSampler`` and ``predictor_propagation``: 600 samples, 5 actions
x repeat 3, 3 iterations, one replan over the 15 steps, two tasks, the
env's two default cameras) and the same ``VMPC_*`` overrides, with the
port's classes.  Its experiment directory is
``campaigns/runs/robot_sawyer_mixed_objects_hardobjects/``.

As written, the policy does not build: ``verbose`` True equals its default,
and ``Policy._override_defaults`` rejects such an override in both packages
(``ValueError``). Drop the key in a copy of this config to run it.

The repo holds no sawyer model: without ``VMPC_MODEL_DIR`` the two-view
predictor is the numpy export ``weights/ag_r5f_v2`` (``adim`` 4, ``sdim``
5) and it plus seeded noise (seed 91), written once under
``build/stand_ins/`` (``stand_ins.py``, which warns).

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robot_sawyer_mixed_objects_hardobjects.py <robot> --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.policy.cem_controllers.pixel_cost_controller import (  # noqa: E501
    PixelCostController)
from visual_foresight_torch.policy.cem_controllers.samplers.folding_sampler import (  # noqa: E501
    FoldingCEMSampler)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robot_sawyer_mixed_objects_hardobjects')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'lower_bound_delta': [0, 0., 0.008, 0., 0],
    'upper_bound_delta': [0, 0., 0.008, 0., 0],
    'normalize_actions': True,
    'gripper_joint_thresh': 0.999856,
    'rand_drop_reset': False,
    'start_box': [1, 1, 0.7],
    'reset_before_eval': False,
    'video_save_dir': '',
    'zthresh': 0.15,
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 15,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'ntask': 2,
}

policy = {
    'type': PixelCostController,
    'verbose': True,
    'replan_interval': 15,
    'num_samples': 600,
    'sampler': FoldingCEMSampler,
    'selection_frac': 0.05,
    'predictor_propagation': True,
    'initial_std': 0.005,
    'initial_std_lift': 0.05,
    'initial_std_rot': np.pi / 10,
    'state_append': [0.41, 0.4, 0.184],
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.second_view(
        'ag_r5f_v2', 91, 'sawyer/mixed_objects/modeldata'),
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
