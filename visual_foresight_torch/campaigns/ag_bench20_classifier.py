"""Goal-conditioned classifier-cost MPC on the grasp-transport set, on the
port.

The twin of ``benchmarks/ag_bench20_classifier/hparams.py``: the same keys
and values and the same ``VMPC_*`` overrides (``VMPC_TASK_SET``,
``VMPC_MODEL_DIR``, ``VMPC_CLASSIFIER_DIR``, ``VMPC_STD_LIFT``), with the
port's classes and the vendored task sets.  The repo holds neither of the
source's trained weights: without ``VMPC_MODEL_DIR`` the predictor is the
numpy export ``weights/ag_r5f_v2`` in place of ``ag_r5f_v1``, and without
``VMPC_CLASSIFIER_DIR`` the classifier is the seeded export
``weights/seeded_classifier`` in place of ``ag_r5_classifier``
(``stand_ins.py``, which warns).  The policy runs on the card; set
``policy['device'] = 'cpu'`` in a copy of this config to run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/ag_bench20_classifier.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/ag_bench20_classifier/
verbose/``.
"""

import os.path

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.cem_controllers.samplers.gaussian_sampler import (  # noqa: E501
    GaussianCEMSampler)
from visual_foresight_torch.policy.cem_controllers.variants.classifier_controller import (  # noqa: E501
    ClassifierController)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'ag_bench20_classifier')
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
        + '/' + os.environ.get('VMPC_TASK_SET', 'ag_bench20'),
    'current_dir': current_dir,
}

policy = {
    'type': ClassifierController,
    'initial_std': 0.04,
    'initial_std_rot': np.pi / 32,
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 768,
    'nactions': 10,
    'T': 30,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'ag_r5f_v1'),
    'classifier_path': os.environ.get('VMPC_CLASSIFIER_DIR') or
        stand_ins.vendored('seeded_classifier', 'ag_r5_classifier'),
    # score the mean of the last 3 predicted frames
    'final_frames': 3,
}

# match the training corpus's z action distribution; identical-to-default
# overrides are rejected by design
_std_lift = float(os.environ.get('VMPC_STD_LIFT', 0.6))
if _std_lift != GaussianCEMSampler.get_default_hparams()['initial_std_lift']:
    policy['initial_std_lift'] = _std_lift

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
