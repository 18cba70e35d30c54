"""NCE-embedding-cost MPC on the 20-task lifting set, on the port.

The twin of ``benchmarks/xz_bench20_nce/hparams.py``: the same keys and
values and the same ``VMPC_*`` overrides (``VMPC_MODEL_DIR``,
``VMPC_EMBEDDING_DIR``), with the port's classes, the numpy export
``weights/xz_flagship`` and the vendored task set ``benchmarks/tasks/
xz_lifting_bench20``.  Cost: the negative dot product of the normalized
embeddings of the final predicted frames and the goal image.  The repo
holds no trained embedding: without ``VMPC_EMBEDDING_DIR`` it is the
seeded export ``weights/seeded_nce`` in place of ``xz_nce``
(``stand_ins.py``, which warns).  The policy runs on the card; set
``policy['device'] = 'cpu'`` in a copy of this config to run it on the
CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/xz_bench20_nce.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/xz_bench20_nce/verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers.variants.nce_cost_controller import (  # noqa: E501
    NCECostController)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'xz_bench20_nce')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': BenchmarkAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/results',
    'T': 45,
    'image_height': 48,
    'image_width': 64,
    'record': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/record/',
    'start_goal_confs': os.environ.get(
        'VMPC_TASK_DIR', os.path.join(REPO_ROOT, 'benchmarks/tasks'))
        + '/xz_lifting_bench20',
    'current_dir': current_dir,
}

policy = {
    'type': NCECostController,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.5,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 768,
    'nactions': 15,
    'T': 45,
    'model_path': os.environ.get(
        'VMPC_MODEL_DIR', os.path.join(PACKAGE, 'weights', 'xz_flagship')),
    'embedding_path': os.environ.get('VMPC_EMBEDDING_DIR') or
        stand_ins.vendored('seeded_nce', 'xz_nce'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': False,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 19,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
