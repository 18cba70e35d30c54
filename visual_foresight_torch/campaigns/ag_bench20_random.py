"""Random-policy baseline on the grasp-transport task sets, on the port.

The twin of ``benchmarks/ag_bench20_random/hparams.py``: the same keys and
values and the same ``VMPC_*`` overrides (``VMPC_TASK_SET`` points it at
``ag_bench20_hard``), with the port's classes and the vendored task sets:
the improvement floor of the grasp-transport MPC rows.  No network, no
card work.  Reports land per task set, in
``runs/ag_bench20_random/results_<task set>/verbose/``.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/ag_bench20_random.py --benchmark
"""

import os.path

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'ag_bench20_random')
current_dir = BASE_DIR

TASK_SET = os.environ.get('VMPC_TASK_SET', 'ag_bench20')

env_params = {
    'num_objects': 3,
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 1,
    'finger_sensors': True,
    'object_object_mindist': 0.15,
    'skip_first': 6,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': os.environ.get('VMPC_RESULT_DIR', BASE_DIR)
        + '/results_' + TASK_SET,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'record': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/record/',
    'start_goal_confs': os.environ.get(
        'VMPC_TASK_DIR', os.path.join(REPO_ROOT, 'benchmarks/tasks'))
        + '/' + TASK_SET,
    'current_dir': current_dir,
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'initial_std': 0.04,
    'initial_std_lift': 0.6,
    'initial_std_rot': np.pi / 32,
}

config = {
    'traj_per_file': 128,
    # reports land in <current_dir>/verbose; one directory a task set
    'current_dir': os.path.join(current_dir, 'results_' + TASK_SET),
    'save_data': False,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 19,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
