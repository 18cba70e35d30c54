"""Random-policy collection on the xz-grasp cartgripper, on the port.

The twin of
``data_collection/sim/cartgripper_xz_grasp/cube_objects/hparams.py``: the
same keys and values (cube objects, T 30, 48x64 frames, a
``GaussianPolicy`` of 10 actions over (x, z, grasp), ``rejection_sample``
5) and the same ``VMPC_*`` overrides, with the port's classes.  Its
experiment directory is
``campaigns/runs/collect_sim_cartgripper_xz_grasp_cube_objects/``.

MuJoCo renders on the host and the policy draws on the host: nothing here
runs on the card.

Run in ``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run \\
        collect_sim_cartgripper_xz_grasp_cube_objects.py [--nworkers N]
"""

import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.random.gaussian import GaussianPolicy

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'collect_sim_cartgripper_xz_grasp_cube_objects')
current_dir = BASE_DIR

env_params = {
    # resolution sufficient for 16x anti-aliasing
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': GeneralAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,            # re-generate scene xml every nth trajectory
    'rejection_sample': 5,   # retry unsuccessful trajs up to 5 attempts
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
    'start_index': 0,
    'end_index': 100000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
