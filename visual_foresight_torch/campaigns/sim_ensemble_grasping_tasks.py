"""Start and goal configurations of the ensemble lifting experiment, on
the port.

The twin of ``experiments/sim/ensemble_grasping/generate_tasks.py``: the
same keys and values, with the port's classes (``CreateConfigAgent``, the
autograsp env with one cube, ``DummyPolicy``).  Each task is a start scene
and, after the objects are moved, its goal: two frames, the reset state and
the object poses, written as raw trajectories under
``<data_save_dir>/train/traj_group0/traj<i>``.  MuJoCo on the host, no
network, no card work.

As written, it makes no task in either package: the config agent moves
the arm with a 5-dim action (``cartgripper_rot_grasp.py::_move_arm``) and
the autograsp env, whose actions are 4-dim, asserts
(``autograsp_env.py::_next_qpos``).

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_ensemble_grasping_tasks/``.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_ensemble_grasping_tasks.py
"""

import os

from visual_foresight_torch.envs.mujoco_env.cartgripper_env.autograsp_env import (  # noqa: E501
    AutograspCartgripperEnv)
from visual_foresight_torch.policy.policy import DummyPolicy
from visual_foresight_torch.sim.util.config_agent import CreateConfigAgent

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_ensemble_grasping_tasks')
current_dir = BASE_DIR

env_params = {
    'num_objects': 1,
    'object_mass': 0.5,
    'friction': 1.0,
    'finger_sensors': True,
    'minlen': 0.03,
    'maxlen': 0.045,
    'object_object_mindist': 0.15,
    'cube_objects': True,
    'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0, 'reopen': True},
}

agent = {
    'type': CreateConfigAgent,
    'env': (AutograspCartgripperEnv, env_params),
    'data_save_dir': BASE_DIR,
    'image_height': 48,
    'T': 1,
    'image_width': 64,
    'gen_xml': 1,
}

config = {
    'current_dir': current_dir,
    'agent': agent,
    'policy': {'type': DummyPolicy},
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 100,
    'ngroup': 1000,
}
