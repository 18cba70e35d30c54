"""Two-camera registration-cost MPC on the sawyer at 96x128, on the port.

The twin of ``experiments/sawyer/registration_experiments/hparams.py``: the
same keys and values (each replan warps the current frame of both default
cameras (``base_env.py``) onto the start and goal images with the GDN and
re-locates the designated pixels over a region
(``RegisterGtruthController``, ``register_region``: 400 samples, 5 actions
x repeat 3, 3 iterations, a replan every 3 of the 50 steps, 96x128 frames))
and the same ``VMPC_*`` overrides, with the port's classes.  Its experiment
directory is ``campaigns/runs/robot_sawyer_registration_experiments/``.

As written, the policy does not build: ``verbose`` True equals its default,
and ``Policy._override_defaults`` rejects such an override in both packages
(``ValueError``). Drop the key in a copy of this config to run it.

The repo holds no model of this experiment, and a 48x64 export cannot serve
96x128 (the CDNA kernel head is a dense layer over the flattened top
encoder map): without ``VMPC_MODEL_DIR`` the predictor is the port's seeded
init at the flagship's widths at 96x128, ``adim`` 4, ``sdim`` 5, two views
(``stand_ins.seeded_predictor``), and without ``VMPC_GDN_DIR`` the GDN the
port's seeded init (``stand_ins.gdn_net``), each written once under
``build/stand_ins/`` and warning.

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robot_sawyer_registration_experiments.py <robot> --benchmark
"""

import os

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.policy.cem_controllers.registration_controller import (  # noqa: E501
    RegisterGtruthController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robot_sawyer_registration_experiments')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'video_save_dir': '',
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 50,
    'image_height': 96,
    'image_width': 128,
    'point_space_width': 64,
    'current_dir': current_dir,
    'register_gtruth': ['start', 'goal'],
}

policy = {
    'type': RegisterGtruthController,
    'verbose': True,
    'initial_std': 0.035,
    'initial_std_lift': 0.08,
    'replan_interval': 3,
    'num_samples': 400,
    'selection_frac': 0.05,
    'register_region': True,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or
        stand_ins.seeded_predictor(
            stand_ins.REG_IMG_DIMS, stand_ins.REG_ADIM,
            stand_ins.REG_SDIM, stand_ins.REG_VIEW_SEEDS,
            'sawyer/registration_experiments/modeldata'),
    'gdn_path': os.environ.get('VMPC_GDN_DIR') or stand_ins.gdn_net(
        'sawyer/registration_experiments/gdn_model'),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': 30000,
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
    'nshuffle': 200,
}
