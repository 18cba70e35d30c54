"""The grasp-transport campaign's scripted pick-and-transport collection, on
the port.

The twin of
``data_collection/sim/cartgripper_grasp/r4_transport_scripted/hparams.py``:
the same keys and values (the same env as ``r4_transport``, the noisy
scripted demonstrator ``GraspTransportPolicy``) and the same ``VMPC_*``
overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/collect_sim_cartgripper_grasp_r4_transport_scripted/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_grasp_r4_transport_scripted.py [--nworkers N]
"""

import os
import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.handcrafted.grasp_transport_policy import (
    GraspTransportPolicy)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_grasp_r4_transport_scripted')
DATA_DIR = os.environ.get('VMPC_DATA_DIR', BASE_DIR + '/data')
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
    'type': GeneralAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': DATA_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,
}

policy = {
    'type': GraspTransportPolicy,
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'skip_bad_trajs': True,
    'seperate_good': True,
    'save_raw_images': False,
    'start_index': int(os.environ.get('VMPC_START_INDEX', 0)),
    'end_index': int(os.environ.get('VMPC_END_INDEX', 100000)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
