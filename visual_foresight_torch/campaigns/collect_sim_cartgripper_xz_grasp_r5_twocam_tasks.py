"""Raw two-camera xz-grasp collection for task selection, on the port.

The twin of
``data_collection/sim/cartgripper_xz_grasp/r5_twocam_tasks/hparams.py``:
the same keys and values (raw frames of both cameras and reset states for
``select_benchmark_tasks``) and the same ``VMPC_*`` overrides, with the
port's classes.  Its experiment directory is
``campaigns/runs/collect_sim_cartgripper_xz_grasp_r5_twocam_tasks/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_xz_grasp_r5_twocam_tasks.py [--nworkers N]
"""

import os
import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_xz_grasp_r5_twocam_tasks')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 2,
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
    'save_reset_data': True,
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
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': int(os.environ.get('VMPC_START_INDEX', 0)),
    'end_index': int(os.environ.get('VMPC_END_INDEX', 59)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
