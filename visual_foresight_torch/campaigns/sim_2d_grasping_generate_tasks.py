"""Expert lifting tasks of the 2D grasping experiments, on the port.

The twin of ``experiments/sim/cartgripper_2d_grasping/generate_tasks/
hparams.py``: the same keys and values, with the port's classes
(``GeneralAgent``, ``CartgripperXZGrasp``, the scripted ``LiftingPolicy``
under rejection sampling): raw start frames and reset states of grasps
that lift, under ``<data_save_dir>/train/traj_group0/traj<i>``.  MuJoCo on
the host, no network, no card work.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_2d_grasping_generate_tasks/``.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_2d_grasping_generate_tasks.py
"""

import os.path

from visual_foresight_torch.agent.general_agent import GeneralAgent
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.handcrafted.lifting_policy import (
    LiftingPolicy)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_2d_grasping_generate_tasks')
current_dir = BASE_DIR

env_params = {
    # render resolution: 16x anti-aliasing over the 48x64 agent frames
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
}

agent = {
    'type': GeneralAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': BASE_DIR,
    'T': 15,
    'image_height': 48,
    'image_width': 64,
    'gen_xml': 1,
    'make_final_gif': '',
    'rejection_sample': 500,
    'save_reset_data': True,
}

policy = {
    'type': LiftingPolicy,
    'sigma': [0.0, 0., 0],
    'frac_act': [0.4, 0.2],
    'bounds': [[-0.4, 0.1], [0.4, 0.15]],
}

config = {
    'current_dir': current_dir,
    'save_data': True,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 10,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
