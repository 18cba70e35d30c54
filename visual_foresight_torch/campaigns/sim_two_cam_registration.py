"""The two-camera registration experiment on the port.

The twin of ``experiments/sim/two_cam_registration/hparams.py``: the same
keys and values and the same ``VMPC_*`` overrides (``VMPC_TASK_DIR``,
``VMPC_GDN_DIR``, ``VMPC_MODEL_DIR``), with the port's classes.  Each
replan warps the current frame of both cameras onto the start and goal
images with the GDN flow net, at 200 x 30 x 3 (10 actions x repeat 3).

As written, the policy does not build: ``register_gtruth``,
``num_samples``, ``repeat`` and ``iterations`` equal their defaults, and
``Policy._override_defaults`` rejects such an override in both packages
(``ValueError``, first on ``register_gtruth``).  Drop the four keys in a
copy of this config to run it.

Paths: the source's experiment directory becomes
``visual_foresight_torch/campaigns/runs/sim_two_cam_registration/``; tasks
are read from ``<it or $VMPC_TASK_DIR>/reg_tasks/raw``.  The repo holds
neither trained model of this experiment: without ``VMPC_MODEL_DIR`` the
two-view predictor is ``weights/xz_flagship`` and it plus seeded noise
(seed 73), without ``VMPC_GDN_DIR`` the GDN is the seeded export
``weights/seeded_gdn`` (``stand_ins.py``, which warns).  The policy runs
on the card; set ``policy['device'] = 'cpu'`` in a copy of this config to
run it on the CPU.

Run::

    python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/sim_two_cam_registration.py \\
        --benchmark
"""

import os.path

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.cartgripper_xz_grasp import (  # noqa: E501
    CartgripperXZGrasp)
from visual_foresight_torch.policy.cem_controllers.registration_controller import (  # noqa: E501
    RegisterGtruthController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'sim_two_cam_registration')
current_dir = BASE_DIR

env_params = {
    'viewer_image_height': 96,
    'viewer_image_width': 128,
    'cube_objects': True,
    'ncam': 2,
}

agent = {
    'type': BenchmarkAgent,
    'env': (CartgripperXZGrasp, env_params),
    'data_save_dir': BASE_DIR,
    'T': 30,
    'image_height': 48,
    'image_width': 64,
    'ntask': 1,
    'make_final_gif_pointoverlay': True,
    'record': BASE_DIR + '/record/',
    'start_goal_confs': os.environ.get('VMPC_TASK_DIR', BASE_DIR)
        + '/reg_tasks/raw',
    'current_dir': current_dir,
}

policy = {
    'type': RegisterGtruthController,
    'action_order': ['x', 'z', 'grasp'],
    'register_gtruth': ['start', 'goal'],
    'gdn_path': os.environ.get('VMPC_GDN_DIR') or stand_ins.vendored(
        'seeded_gdn', 'two_cam_registration/gdn_model'),
    'rejection_sampling': False,
    'replan_interval': 10,
    'num_samples': 200,
    'nactions': 10,
    'repeat': 3,
    'T': 30,
    'iterations': 3,
    'predictor_hparams': {
        'ncam': 2,
    },
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.second_view(
        'xz_flagship', 73, 'two_cam_registration/modeldata'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': False,
    'seperate_good': False,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 9,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
}
