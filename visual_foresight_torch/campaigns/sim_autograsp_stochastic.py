"""The stochastic-predictor autograsp experiment on the port.

The twin of ``experiments/sim/autograsp_stochastic/hparams.py``: the same
keys and values and the same ``VMPC_*`` overrides (``VMPC_TASK_DIR``,
``VMPC_MODEL_DIR``), with the port's classes.  The policy samples
xyz/theta deltas at 600 x 30 x 3 (10 actions x repeat 3); the env latches
the gripper; the predictor draws one latent a sample (``latent_dim`` 8).

As written, the policy does not build: ``repeat`` 3 and ``iterations`` 3
equal their defaults, and ``Policy._override_defaults`` rejects such an
override in both packages (``ValueError``).  Drop the two keys in a copy of
this config to run it.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_autograsp_stochastic/``; tasks
are read from ``<it or $VMPC_TASK_DIR>/ag_tasks/raw``.  The repo holds no
``modeldata`` of this experiment: without ``VMPC_MODEL_DIR`` the predictor
is the numpy export ``weights/ag_r5f_v2`` (``latent_dim`` 8, ``adim`` 4,
``sdim`` 5; ``stand_ins.py``, which warns).  The policy runs on the card;
set ``policy['device'] = 'cpu'`` in a copy of this config to run it on the
CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_autograsp_stochastic.py \\
        --benchmark
"""

import os.path

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.cem_controllers import PixelCostController

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_autograsp_stochastic')
current_dir = BASE_DIR

env_params = {
    'num_objects': 3,
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 1,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'make_final_gif_pointoverlay': True,
    'record': BASE_DIR + '/record/',
    'start_goal_confs': os.environ.get('VMPC_TASK_DIR', BASE_DIR)
        + '/ag_tasks/raw',
    'current_dir': current_dir,
}

policy = {
    'type': PixelCostController,
    'initial_std': 0.04,
    'initial_std_lift': 0.6,
    'initial_std_rot': np.pi / 32,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 600,
    'nactions': 10,
    'repeat': 3,
    'T': 30,
    'iterations': 3,
    'predictor_hparams': {
        # the stochastic variant: a latent a sample while planning
        'latent_dim': 8,
        'adim': 4,
        'sdim': 5,
    },
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'autograsp_stochastic/modeldata'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': False,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 9,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
