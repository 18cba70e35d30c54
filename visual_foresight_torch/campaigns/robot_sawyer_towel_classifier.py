"""Towel folding with a success-classifier cost and the folding prior on the
sawyer, on the port.

The twin of ``experiments/sawyer/towel_classifier/hparams.py``: the same
keys and values (one camera, ``ClassifierController`` with
``FoldingCEMSampler``: 18 samples, 5 actions x repeat 3, 3 iterations, one
replan over the 15 steps, every iteration dumped) and the same ``VMPC_*``
overrides, with the port's classes.  Its experiment directory is
``campaigns/runs/robot_sawyer_towel_classifier/``.

The repo holds neither trained net: without ``VMPC_MODEL_DIR`` the
predictor is the numpy export ``weights/ag_r5f_v2``, without
``VMPC_CLASSIFIER_DIR`` the classifier the seeded export
``weights/seeded_classifier`` (``stand_ins.py``, which warns).
``state_append`` stays as the source writes it; the classifier controller
does not declare it, so in both packages the policy raises ``KeyError`` on
it as written: drop it in a copy of this config to run it.

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robot_sawyer_towel_classifier.py <robot> --benchmark
"""

import os

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.cem_controllers.samplers.folding_sampler import (  # noqa: E501
    FoldingCEMSampler)
from visual_foresight_torch.policy.cem_controllers.variants.classifier_controller import (  # noqa: E501
    ClassifierController)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robot_sawyer_towel_classifier')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'start_box': [1, 1, 0.7],
    'reset_before_eval': False,
    'rand_drop_reset': False,
    'save_video': True,
    'camera_topics': [IMTopic('/front/image_raw', flip=True)],
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 15,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'no_goal_def': True,
}

policy = {
    'type': ClassifierController,
    'replan_interval': 15,
    'num_samples': 18,
    'selection_frac': 0.05,
    'sampler': FoldingCEMSampler,
    'initial_std': 0.005,
    'initial_std_lift': 0.05,
    'verbose_every_iter': True,
    'state_append': [0.41, 0.25, 0.166],
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'sawyer/towel_classifier/modeldata'),
    # native classifier checkpoint (replaces the reference's external
    # control_embedding classifier_conf_path/classifier_restore_path)
    'classifier_path': os.environ.get('VMPC_CLASSIFIER_DIR') or
        stand_ins.vendored(
            'seeded_classifier', 'sawyer/towel_classifier/classifier_model'),
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
