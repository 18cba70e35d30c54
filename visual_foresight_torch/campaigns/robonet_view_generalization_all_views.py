"""RoboNet pixel-cost benchmark on the port: a multi-view model on a held-out
view.

The twin of ``experiments/robonet/view_generalization/all_views.py``: the
same keys and values (MPPI (``CorrelatedNoiseSampler``) of 10 actions, 5
iterations, 10 % elites, drawn warm-up actions until step 5, a replan every
10 steps, one camera) and the same ``VMPC_*`` overrides, with the port's
classes.  Its experiment directory is
``campaigns/runs/robonet_view_generalization_all_views/``.

The repo holds no model of this experiment: without ``VMPC_MODEL_DIR`` the
predictor is the numpy export ``weights/ag_r5f_v2`` (``adim`` 4, ``sdim``
5; ``stand_ins.py``, which warns).

As written the policy plans only in the host CEM loop: ``nactions`` 10
under the controller's default ``T`` of 15 stops the fused MPPI planner,
which plans at control cadence (``nactions == T``), so the controller
raises ``ValueError`` in the port (``AssertionError`` in the JAX package).
Set ``policy['use_fused_planner'] = False`` in a copy of this config to run
it (``chip_smoke.py`` does).

The policy runs on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run it on the CPU.

Run on a machine with the arm, its cameras and ROS, in
``visual_foresight_torch/campaigns/``::

    python -m visual_foresight_torch.sim.run_robot \\
        robonet_view_generalization_all_views.py <robot> --benchmark
"""

import os

import numpy as np

from visual_foresight_torch.agent.benchmarking_agent import BenchmarkAgent
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.envs.robot_envs.autograsp_env import AutograspEnv
from visual_foresight_torch.envs.robot_envs.util.topic_utils import IMTopic
from visual_foresight_torch.policy.cem_controllers.pixel_cost_controller import (  # noqa: E501
    PixelCostController)
from visual_foresight_torch.policy.cem_controllers.samplers.correlated_noise import (  # noqa: E501
    CorrelatedNoiseSampler)

BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'robonet_view_generalization_all_views')
current_dir = BASE_DIR

env_params = {
    'robot_name': 'sawyer',
    'camera_topics': [IMTopic('/other/image_raw', flip=False)],
    'cleanup_rate': -1,
    'save_video': True,
}

agent = {
    'type': BenchmarkAgent,
    'env': (AutograspEnv, env_params),
    'data_save_dir': BASE_DIR,
    'T': 14,
    'image_height': 48,
    'image_width': 64,
    'make_final_recording': '',

}

policy = {
    'type': PixelCostController,
    'verbose_every_iter': True,
    'zeros_for_start_frames': False,
    'replan_interval': 10,
    'start_planning': 5,
    'iterations': 5,
    'selection_frac': 1. / 10,
    'nactions': 10,
    'num_samples': 600,
    'sampler': CorrelatedNoiseSampler,
    'model_path': os.environ.get('VMPC_MODEL_DIR') or stand_ins.vendored(
        'ag_r5f_v2', 'robonet/view_generalization/modeldata'),
}

config = {
    'experiment_name': 'view_gen_all_views',
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
