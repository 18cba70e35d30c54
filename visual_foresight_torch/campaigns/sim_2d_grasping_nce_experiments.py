"""The NCE-embedding-cost 2D grasping experiment on the port.

The twin of ``experiments/sim/cartgripper_2d_grasping/nce_experiments/
hparams.py``: the same keys and values and the same ``VMPC_*`` overrides
(``VMPC_DATA_DIR``, ``VMPC_MODEL_DIR``, ``VMPC_NCE_DIR``), with the port's
classes: 800 samples, the controllers' default horizon (15) and 3
iterations, 5 % elites, a replan every 5 steps of 45.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_2d_grasping_nce_experiments/``;
tasks are read from ``<it or $VMPC_DATA_DIR>/cartgripper_xz_grasp/
expert_lifting_tasks``.  The repo holds neither trained model of this
experiment: without ``VMPC_MODEL_DIR`` the predictor is the numpy export
``weights/xz_flagship``, without ``VMPC_NCE_DIR`` the embedding is the
seeded export ``weights/seeded_nce`` (``stand_ins.py``, which warns).  The
policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_2d_grasping_nce_experiments.py \\
        --benchmark
"""

import os

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers.variants.nce_cost_controller import (  # noqa: E501
    NCECostController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_2d_grasping_nce_experiments')
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
    'num_load_steps': 16,
    'make_final_recording': '',
    'start_goal_confs': os.environ.get('VMPC_DATA_DIR', BASE_DIR) +
        '/cartgripper_xz_grasp/expert_lifting_tasks',
    'current_dir': current_dir,
}

policy = {
    'type': NCECostController,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.5,
    'rejection_sampling': False,
    'selection_frac': 0.05,
    'replan_interval': 5,
    'num_samples': 800,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'xz_flagship', 'cartgripper_2d_grasping/nce_experiments/modeldata'),
    'embedding_path': os.environ.get('VMPC_NCE_DIR') or stand_ins.vendored(
        'seeded_nce', 'cartgripper_2d_grasping/nce_experiments/nce_model'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 20,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
