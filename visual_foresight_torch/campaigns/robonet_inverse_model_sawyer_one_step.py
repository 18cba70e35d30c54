"""Inverse-model control at 192x256, on the port: the Sawyer one-step model, T
10, a plan every step.

The twin of ``experiments/robonet/inverse_model/sawyer_one_step.py``: the
same keys and values (``InvModelBaseController`` maps the current and goal
images to a plan of actions; 192x256 frames, one camera) and the same
``VMPC_*`` overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/robonet_inverse_model_sawyer_one_step/``.

No video prediction, no sampling, no tail.  The repo holds no inverse net
of this experiment: without ``VMPC_INVMODEL_DIR`` both its paths are the
port's seeded init of ``models/inverse.py`` at ``adim`` 4
(``stand_ins.inverse_net``, written once under ``build/stand_ins/``, which
warns). The net pools its encoder map globally, so it serves 192x256 frames
at the same widths.

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robonet_inverse_model_sawyer_one_step.py <robot> --benchmark
"""

import os

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.inverse_models.inverse_model_base_controller import (  # noqa: E501
    InvModelBaseController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robonet_inverse_model_sawyer_one_step')
current_dir = BASE_DIR
INVMODEL_DIR = os.environ.get('VMPC_INVMODEL_DIR') or \
    stand_ins.inverse_net('robonet/inverse_model/invmodel')

env_params = {
    'robot_name': 'sawyer',
    'camera_topics': [IMTopic('/front/image_raw', flip=True)],
    'cleanup_rate': -1,
    'save_video': True,
    'gripper_attached': 'wsg-50',
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'T': 10,
    'image_height': 192,
    'image_width': 256,
    'make_final_recording': '',
    'goal_image_only': '',
    'no_goal_def': '',
    'data_save_dir': BASE_DIR + '/outputs',
}

policy = {
    'type': InvModelBaseController,
    'model_params_path': INVMODEL_DIR,
    'model_restore_path': INVMODEL_DIR,
    'replan_every': 1,
}

config = {
    'experiment_name': 'sawyer_one_step',
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
