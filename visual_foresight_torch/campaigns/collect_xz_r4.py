"""Random-policy data collection on the xz-grasp cartgripper, on the port.

The twin of ``data_collection/sim/cartgripper_xz_grasp/r4_flagship/
hparams.py``: the same keys and values (cube objects, T 30, 48x64 frames,
a ``GaussianPolicy`` of 10 actions, ``rejection_sample`` 5) and the same
``VMPC_*`` overrides, with the port's classes; without ``VMPC_DATA_DIR``
the data go under ``campaigns/runs/collect_xz_r4/data``.  The policy draws on the
host; MuJoCo renders on the host.  Nothing here runs on the card.

Run::

    VMPC_DATA_DIR=<out> VMPC_END_INDEX=<n - 1> \\
        python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/collect_xz_r4.py [--nworkers N]

Records: ``$VMPC_DATA_DIR/records/{good,bad}/{train,val,test}/`` with their
manifests (``seperate_good``), readable by ``data.dataset_reader``.
"""

import os
import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_xz_r4')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': GeneralAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': DATA_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,
    'rejection_sample': 5,
}

policy = {
    'type': GaussianPolicy,
    'nactions': 10,
    'action_order': ['x', 'z', 'grasp'],
    'initial_std_lift': 0.1,
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'seperate_good': True,
    'save_raw_images': False,
    'start_index': int(os.environ.get('VMPC_START_INDEX', 0)),
    'end_index': int(os.environ.get('VMPC_END_INDEX', 100000)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
