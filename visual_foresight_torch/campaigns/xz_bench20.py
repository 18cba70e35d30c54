"""The 20-task lifting benchmark on the port: pixel-cost MPC, flagship
predictor.

The twin of ``benchmarks/xz_bench20/hparams.py``: the same keys and values
and the same ``VMPC_*`` overrides, with the port's classes, the numpy export
``visual_foresight_torch/weights/xz_flagship`` and the vendored task set
``benchmarks/tasks/xz_lifting_bench20``.  The policy runs on the card; set
``policy['device'] = 'cpu'`` in a copy of this config to run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/xz_bench20.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/xz_bench20/verbose/``
(``results_0to19.txt``, ``scores_0to19.pkl``, ``results_all.txt``); the plan
dumps under ``$VMPC_RESULT_DIR`` or ``runs/xz_bench20/results/verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers import PixelCostController

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'xz_bench20')
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
    'type': PixelCostController,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.5,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': int(os.environ.get('VMPC_NUM_SAMPLES', 768)),
    'nactions': 15,
    # repeat=3 and iterations=3 are the defaults (overriding with the
    # default raises by design)
    'T': 45,
    'model_path': os.environ.get(
        'VMPC_MODEL_DIR', os.path.join(PACKAGE, 'weights', 'xz_flagship')),
}

# device microbatch over the sample axis (planners/cem.py sample_chunk);
# only set when non-zero: 0 is the controller default and identical
# overrides are rejected by design
_chunk = int(os.environ.get('VMPC_SAMPLE_CHUNK', 0))
if _chunk:
    policy['sample_chunk'] = _chunk

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
