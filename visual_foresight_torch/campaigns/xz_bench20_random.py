"""Random-policy baseline on the 20-task lifting set, on the port.

The twin of ``benchmarks/xz_bench20_random/hparams.py``: the same keys and
values and the same ``VMPC_*`` overrides, with the port's classes and the
vendored task set ``benchmarks/tasks/xz_lifting_bench20``: the
collection-time Gaussian policy in place of MPC, the floor every MPC row
is compared against.  No network, no card work.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/xz_bench20_random.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/xz_bench20_random/
verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'xz_bench20_random')
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
    'type': GaussianPolicy,
    'nactions': 15,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.1,
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
