"""The grasp-transport campaign's random autograsp collection, on the port.

The twin of
``data_collection/sim/cartgripper_grasp/r4_transport/hparams.py``: the same
keys and values (3 cubes at the ``ag_bench20`` env's parameters, a 4-dim
``GaussianPolicy`` of 10 actions, ``VMPC_STD_LIFT`` setting its z std) and
the same ``VMPC_*`` overrides, with the port's classes.  Its experiment
directory is
``campaigns/runs/collect_sim_cartgripper_grasp_r4_transport/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_grasp_r4_transport.py [--nworkers N]
"""

import os
import os.path

import numpy as np

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_grasp_r4_transport')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')
current_dir = BASE_DIR

env_params = {
    'num_objects': 3,
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 1,
    'finger_sensors': True,
    # spaced spawns cut the born-bad-scene rate (overlap -> solver ejection
    # through the floor); same value the reference's grasping experiments
    # use (reference experiments/sim/ensemble_grasping/hparams.py:20)
    'object_object_mindist': 0.15,
    # the library default (40 blocks x 500 substeps x dt=0.005 = 100
    # simulated seconds, reference parity) spends 70% of collection time
    # settling an already-settled scene: final object z is identical to 4
    # decimals from 4 blocks up (measured).  6 blocks = 15 sim-seconds.
    'skip_first': 6,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': GeneralAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': DATA_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,
    # no rejection sampling: the campaign needs maximum trajectory
    # throughput and diverse (incl. failed-grasp) data
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'initial_std': 0.04,
    'initial_std_rot': np.pi / 32,
}

# z-sampling std, env-overridable so one conf collects either the 0.6
# exploration corpus (r4/r4b) or a corpus matched to the campaign planning
# std (VMPC_STD_LIFT=0.15 — the CEM probe distribution the predictor must
# cover at plan time).  Identical-to-default overrides are rejected by
# design, so only set the key when it differs from the GaussianPolicy
# default.
_std_lift = float(os.environ.get('VMPC_STD_LIFT', 0.6))
if _std_lift != GaussianPolicy.DEFAULT_HPARAMS['initial_std_lift']:
    policy['initial_std_lift'] = _std_lift

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'skip_bad_trajs': True,   # unattended campaign: skip unproducible indices
    'seperate_good': True,
    'save_raw_images': False,
    'start_index': int(os.environ.get('VMPC_START_INDEX', 0)),
    'end_index': int(os.environ.get('VMPC_END_INDEX', 100000)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
