"""Ensemble-disagreement MPC on the 20-task lifting set, on the port.

The twin of ``benchmarks/xz_bench20_ensemble/hparams.py``: the same keys
and values and the same ``VMPC_*`` overrides, with the port's classes and
the vendored task set ``benchmarks/tasks/xz_lifting_bench20``.  Cost: mean
pixel cost + lambda x the variance across three members.  With
``VMPC_MODEL_ROOT`` the members are ``$VMPC_MODEL_ROOT/xz_ens1``,
``xz_ens2`` and ``xz_ens3``, as in the source; the repo holds none of
them, so without it they are the numpy export ``weights/xz_flagship`` and
two copies of it plus seeded noise (seeds 71 and 72: the members of the
ensemble's golden; ``stand_ins.py``, which warns).  The policy runs on the
card; set ``policy['device'] = 'cpu'`` in a copy of this config to run it
on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/xz_bench20_ensemble.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/xz_bench20_ensemble/
verbose/``.
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers.variants.ensemble_vidpred import (  # noqa: E501
    CEMControllerEnsembleVidPred)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'xz_bench20_ensemble')
current_dir = BASE_DIR

MODEL_ROOT = os.environ.get('VMPC_MODEL_ROOT')

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
    'type': CEMControllerEnsembleVidPred,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.5,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 768,
    'nactions': 15,
    'T': 45,
    # num_ensembles=3 and ensemble_var_lambda=1.0 are the defaults
    'model_path': [MODEL_ROOT + '/xz_ens1',
                   MODEL_ROOT + '/xz_ens2',
                   MODEL_ROOT + '/xz_ens3'] if MODEL_ROOT else [
        stand_ins.vendored('xz_flagship', 'xz_ens1'),
        stand_ins.noisy_copy('xz_flagship', 71, 'xz_ens2'),
        stand_ins.noisy_copy('xz_flagship', 72, 'xz_ens3')],
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
