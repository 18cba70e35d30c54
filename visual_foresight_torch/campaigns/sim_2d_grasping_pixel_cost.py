"""The pixel-cost 2D grasping experiment on the port.

The twin of ``experiments/sim/cartgripper_2d_grasping/pixel_cost/
hparams.py``: the same keys and values and the same ``VMPC_*`` overrides
(``VMPC_DATA_DIR``, ``VMPC_MODEL_DIR``), with the port's classes: the
lifting task at 800 x 45 x 3 (15 actions x repeat 3).

As written, the policy does not build: ``repeat`` 3 equals its default,
and ``Policy._override_defaults`` rejects such an override in both
packages (``ValueError``).  Drop the key in a copy of this config to run
it.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_2d_grasping_pixel_cost/``;
tasks are read from ``<it or $VMPC_DATA_DIR>/cartgripper_xz_grasp/
lifting_tasks/raw`` (``traj_group0/traj<i>``: link the ``train/`` folder
that ``sim_2d_grasping_create_configs.py`` writes there).  Without ``VMPC_MODEL_DIR`` the predictor is the
numpy export ``weights/xz_flagship`` in place of the experiment's
``modeldata`` (``stand_ins.py``, which warns).  The policy runs on the
card; set ``policy['device'] = 'cpu'`` in a copy of this config to run it
on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_2d_grasping_pixel_cost.py \\
        --benchmark
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers import PixelCostController

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_2d_grasping_pixel_cost')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': BenchmarkAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': BASE_DIR,
    'T': 45,
    'image_height': 48,
    'image_width': 64,
    'make_final_gif_pointoverlay': True,
    'record': BASE_DIR + '/record/',
    'start_goal_confs': os.environ.get('VMPC_DATA_DIR', BASE_DIR) +
        '/cartgripper_xz_grasp/lifting_tasks/raw',
    'current_dir': current_dir,
}

policy = {
    'type': PixelCostController,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.5,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 800,
    'nactions': 15,
    'repeat': 3,
    'T': 45,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'xz_flagship', 'cartgripper_2d_grasping/pixel_cost/modeldata'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': False,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 5,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
