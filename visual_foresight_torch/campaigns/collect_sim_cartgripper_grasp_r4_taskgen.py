"""Raw autograsp collection for transport task generation, on the port.

The twin of
``data_collection/sim/cartgripper_grasp/r4_taskgen/hparams.py``: the same
keys and values (3 cubes at the benchmark env's parameters, raw frames and
reset states kept for ``select_benchmark_tasks`` and
``make_transport_tasks``) and the same ``VMPC_*`` overrides, with the
port's classes.  Its experiment directory is
``campaigns/runs/collect_sim_cartgripper_grasp_r4_taskgen/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_grasp_r4_taskgen.py [--nworkers N]
"""

import os
import os.path

import numpy as np

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_grasp_r4_taskgen')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')
current_dir = BASE_DIR

env_params = {
    'num_objects': 3,
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 1,
    'finger_sensors': True,
    # must match r4_transport campaign params so the benchmark tasks are
    # on-distribution for the trained predictor
    'object_object_mindist': 0.15,
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
    'save_reset_data': True,
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
    'current_dir': current_dir,
    'save_data': True,
    'skip_bad_trajs': True,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': int(os.environ.get('VMPC_START_INDEX', 0)),
    'end_index': int(os.environ.get('VMPC_END_INDEX', 119)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
