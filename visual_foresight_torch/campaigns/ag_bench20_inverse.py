"""Inverse-model baseline on the grasp-transport set, on the port.

The twin of ``benchmarks/ag_bench20_inverse/hparams.py``: the same keys
and values (``imax`` 10, ``skip_bad_trajs``) and the same ``VMPC_*``
overrides, with the port's classes and the vendored task set
``benchmarks/tasks/ag_bench20``.  No video prediction, no sampling, no
tail.  The repo holds no inverse net of ``adim`` 4: without
``VMPC_MODEL_DIR`` it is the port's seeded init of ``models/inverse.py``
at ``adim`` 4, written once under ``build/stand_ins/`` in place of
``ag_r5_inverse`` (``stand_ins.py``, which warns).  The policy runs on
the card; set ``policy['device'] = 'cpu'`` in a copy of this config to run
it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/ag_bench20_inverse.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/ag_bench20_inverse/
verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.inverse_models.inverse_model_base_controller import (  # noqa: E501
    InvModelBaseController)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'ag_bench20_inverse')
current_dir = BASE_DIR

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
    'data_save_dir': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/results',
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'record': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/record/',
    'start_goal_confs': os.environ.get(
        'VMPC_TASK_DIR', os.path.join(REPO_ROOT, 'benchmarks/tasks'))
        + '/ag_bench20',
    # validity failures under a deterministic feed-forward policy repeat
    # identically; 10 attempts (2 scene regens) tell a transient fault from
    # a task this policy cannot keep valid
    'imax': 10,
    'current_dir': current_dir,
}

policy = {
    'type': InvModelBaseController,
    'T': 30,
    'model_params_path': os.environ.get('VMPC_MODEL_DIR') or
        stand_ins.inverse_net('ag_r5_inverse'),
}

config = {
    # a task whose every retry fails validity is skipped (logged) and the
    # rest scored (sim/benchmarks.py)
    'skip_bad_trajs': True,
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
