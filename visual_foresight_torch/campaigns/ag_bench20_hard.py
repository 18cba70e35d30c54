"""The grasp-transport benchmark on its hard task set, on the port:
pixel-cost MPC with the latent-dispersion lever.

The twin of ``benchmarks/ag_bench20_hard/hparams.py``: the same keys and
values and the same ``VMPC_*`` overrides (``VMPC_REPLAN``,
``VMPC_STD_LIFT``, and ``VMPC_STOCH_K``/``VMPC_STOCH_PEN``, which set
``stochastic_planning`` and ``stochastic_penalty`` only when asked), with
the port's classes, the numpy export ``visual_foresight_torch/weights/
ag_r5f_v2`` and the vendored task set ``benchmarks/tasks/ag_bench20_hard``
(the task set is the run directory's name, as in the source).  The policy
runs on the card; set ``policy['device'] = 'cpu'`` in a copy of this
config to run it on the CPU.

Run::

    VMPC_STOCH_K=2 VMPC_STOCH_PEN=1.0 \\
        python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/ag_bench20_hard.py --benchmark

Reports: ``visual_foresight_torch/campaigns/runs/ag_bench20_hard/verbose/``.
"""

import os.path

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.cem_controllers import PixelCostController
from visual_foresight_torch.policy.cem_controllers.samplers.gaussian_sampler import (  # noqa: E501
    GaussianCEMSampler)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'ag_bench20_hard')
current_dir = BASE_DIR

TASK_SET = os.path.basename(BASE_DIR.rstrip('/'))

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
        + '/' + TASK_SET,
    'current_dir': current_dir,
}

policy = {
    'type': PixelCostController,
    'initial_std': 0.04,
    'initial_std_rot': np.pi / 32,
    'rejection_sampling': False,
    # cadence env-overridable for the replan-density experiment; use 1 for
    # replan-every-step (0 equals the controller default and would be
    # rejected as a no-op override)
    'replan_interval': int(os.environ.get('VMPC_REPLAN', 10)),
    # transport moves the object far from its start pixel: carry the best
    # predicted distribution across replans
    'predictor_propagation': True,
    'num_samples': 768,
    'nactions': 10,
    'T': 30,
    'model_path': os.environ.get('VMPC_MODEL_DIR', '') or os.path.join(
        PACKAGE, 'weights', 'ag_r5f_v2'),
}

# match the training corpus's z action distribution; identical-to-default
# overrides are rejected by design, so the key is set only where it differs
# from the GaussianCEMSampler default
_std_lift = float(os.environ.get('VMPC_STD_LIFT', 0.6))
if _std_lift != GaussianCEMSampler.get_default_hparams()['initial_std_lift']:
    policy['initial_std_lift'] = _std_lift

# latent-dispersion planning: K prior-latent copies per unique plan, elites
# on mean + lambda * std across copies; set only when asked
_stoch_k = int(os.environ.get('VMPC_STOCH_K', 0))
if _stoch_k > 1:
    policy['stochastic_planning'] = (_stoch_k,)
_stoch_pen = float(os.environ.get('VMPC_STOCH_PEN', 0))
if _stoch_pen:
    policy['stochastic_penalty'] = _stoch_pen

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
