"""Two-camera registration-cost MPC on the 20-task two-camera set, on the
port.

The twin of ``benchmarks/xz2c_bench20_registration/hparams.py``: the same
keys and values and the same ``VMPC_*`` overrides (``VMPC_GDN_DIR``,
``VMPC_MODEL_DIR``), with the port's classes and the vendored task set
``benchmarks/tasks/xz2c_bench20``.  Each replan warps the current frame of
both cameras onto the start and goal images with the GDN flow net; the
warp errors weigh the pixel-distance cost.  The repo holds neither of the
source's trained weights: without ``VMPC_MODEL_DIR`` the two-view
predictor is ``weights/xz_flagship`` for view 0 and it plus seeded noise
(seed 73: the view of the registration golden) for view 1, in place of
``xz2c_reg``; without ``VMPC_GDN_DIR`` the GDN is the seeded export
``weights/seeded_gdn`` in place of ``xz2c_gdn`` (``stand_ins.py``, which
warns).  The policy runs on the card; set ``policy['device'] = 'cpu'`` in
a copy of this config to run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/xz2c_bench20_registration.py \\
        --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/xz2c_bench20_registration/
verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers.registration_controller import (  # noqa: E501
    RegisterGtruthController)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'xz2c_bench20_registration')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 2,
}

agent = {
    'type': BenchmarkAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/results',
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'record': os.environ.get('VMPC_RESULT_DIR', BASE_DIR) + '/record/',
    'start_goal_confs': os.environ.get(
        'VMPC_TASK_DIR', os.path.join(REPO_ROOT, 'benchmarks/tasks'))
        + '/xz2c_bench20',
    'current_dir': current_dir,
}

policy = {
    'type': RegisterGtruthController,
    'action_order': ['x', 'z', 'grasp'],
    'gdn_path': os.environ.get('VMPC_GDN_DIR') or stand_ins.vendored(
        'seeded_gdn', 'xz2c_gdn'),
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 768,
    'nactions': 10,
    'T': 30,
    'predictor_hparams': {
        'ncam': 2,
    },
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.second_view(
        'xz_flagship', 73, 'xz2c_reg'),
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
