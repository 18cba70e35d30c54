"""The ensemble-disagreement lifting experiment on the port.

The twin of ``experiments/sim/ensemble_grasping/hparams.py``: the same
keys and values and the same ``VMPC_*`` overrides (``VMPC_DATA_DIR``,
``VMPC_MODEL_DIR``), with the port's classes: lift one cube with an
uncertainty-penalized pixel cost, 800 samples, the controllers' default
horizon (15) and 3 iterations.  ``model_path`` is one directory and
``num_ensembles`` keeps its default, 3: the ensemble is three copies of
the one restored predictor, as in the JAX package.

As written, the policy does not build: ``verbose`` True equals its
default, and ``Policy._override_defaults`` rejects such an override in
both packages (``ValueError``).  Drop the key in a copy of this config to
run it.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_ensemble_grasping/``; tasks
are read from ``<it or $VMPC_DATA_DIR>/ensemble_lifting_tasks``
(``traj_group0/traj<i>``, 16 frames each: ``num_load_steps``).  Without ``VMPC_MODEL_DIR`` the
predictor is the numpy export ``weights/ag_r5f_v2`` (``adim`` 4, ``sdim``
5) in place of the experiment's ``modeldata`` (``stand_ins.py``, which
warns).  The policy runs on the card; set ``policy['device'] = 'cpu'`` in
a copy of this config to run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_ensemble_grasping.py --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.cem_controllers.variants.ensemble_vidpred import (  # noqa: E501
    CEMControllerEnsembleVidPred)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_ensemble_grasping')
current_dir = BASE_DIR

env_params = {
    'num_objects': 1,
    'object_mass': 0.5,
    'friction': 1.0,
    'finger_sensors': True,
    'minlen': 0.03,
    'maxlen': 0.06,
    'object_object_mindist': 0.15,
    'cube_objects': True,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'data_save_dir': BASE_DIR,
    'make_final_gif_pointoverlay': True,
    'record': BASE_DIR + '/record/',
    'num_load_steps': 16,
    'start_goal_confs': os.environ.get('VMPC_DATA_DIR', BASE_DIR) +
        '/ensemble_lifting_tasks',
    'current_dir': current_dir,
}

policy = {
    'type': CEMControllerEnsembleVidPred,
    'verbose': True,
    'initial_std': 0.04,
    'initial_std_lift': 0.6,
    'initial_std_rot': np.pi / 32,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 800,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'ensemble_grasping/modeldata'),
}

config = {
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 88,
    'agent': agent,
    'policy': policy,
}
