"""Start and goal configurations of the 2D grasping task, on the port.

The twin of ``experiments/sim/cartgripper_2d_grasping/create_configs/
hparams.py``: the same keys and values, with the port's classes
(``CreateConfigAgent``, ``CartgripperXZGrasp``, ``NullPolicy``).  Each task
is a start scene and its goal, written as raw trajectories (two frames,
the reset state) under ``<data_save_dir>/train/traj_group0/traj<i>``.
MuJoCo on the host, no network, no card work.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_2d_grasping_create_configs/``.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_2d_grasping_create_configs.py
"""

import os.path

from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.policy import NullPolicy
from visual_foresight_torch.sim.util.config_agent import CreateConfigAgent

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_2d_grasping_create_configs')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': CreateConfigAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': BASE_DIR + '/lifting_tasks',
    'T': 1,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,
    'save_reset_data': True,
}

policy = {
    'type': NullPolicy,
}

config = {
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 19,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
