"""Offline replay planned by the classifier cost, on the port.

The twin of ``experiments/offline_exp/towel_classifier/hparams.py`` (and
its ``conf.py``): ``OfflineAgent`` replays logged raw trajectories through
``OfflineSawyerEnv`` while ``ClassifierController`` plans each episode with
``FoldingCEMSampler`` (600 samples, one replan of 15 steps a 15-step
episode, 5 % elites) in the host CEM loop, and the run writes each episode
as a raw trajectory folder (``save_raw_images``).  The predictor and the
classifier run on the card; set ``policy['device'] = 'cpu'`` in a copy of
this config to run them on the CPU.

What differs from the source, which the repo cannot run as written:

- Weights: the repo holds no towel predictor or towel classifier, so the
  predictor is ``weights/ag_r5f_v2`` (adim 4, sdim 5) and the classifier
  the seeded export ``weights/seeded_classifier``, as the classifier
  campaign substitutes them (``VMPC_MODEL_DIR`` and
  ``VMPC_CLASSIFIER_DIR`` override both).
- ``state_append``: neither package's ``ClassifierController`` declares
  it (the JAX one raises ``KeyError`` on the source as written), so it is
  left out; the replayed states carry the weights' full width, 5, which is
  the logged (x, y) with the source's three appended constants
  ``STATE_APPEND`` after them.
- The env's widths (``adim`` 4, ``sdim`` 5, one camera) and its
  ``data_dir`` are set here (``VMPC_REPLAY_DIR``, the raw trajectories
  ``traj_group*/traj*`` to replay); the source leaves them at the env's
  defaults (adim 3) and its working directory.
- The episodes go to ``VMPC_DATA_DIR`` (default
  ``campaigns/runs/offline_towel_classifier``), whose ``train/`` must not be
  the replay directory.

Run::

    VMPC_REPLAY_DIR=<raw trajectories> VMPC_END_INDEX=<n - 1> \\
        python -m visual_foresight_torch.sim.run \\
        visual_foresight_torch/campaigns/offline_towel_classifier.py
"""

import os

from visual_foresight_torch.agent.offline_agent import OfflineAgent
from visual_foresight_torch.envs.offline_env import OfflineSawyerEnv
from visual_foresight_torch.policy.cem_controllers.samplers.folding_sampler import (  # noqa: E501
    FoldingCEMSampler)
from visual_foresight_torch.policy.cem_controllers.variants.classifier_controller import (  # noqa: E501
    ClassifierController)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'runs',
                        'offline_towel_classifier')
current_dir = BASE_DIR
# the source's state_append, which the replayed states carry
STATE_APPEND = [0.41, 0.25, 0.166]

env_params = {
    'data_dir': os.environ.get('VMPC_REPLAY_DIR', BASE_DIR + '/replay'),
    'adim': 4,
    'sdim': 5,
}

agent = {
    'type': OfflineAgent,
    'env': (OfflineSawyerEnv, env_params),
    'data_save_dir': os.environ.get('VMPC_DATA_DIR', BASE_DIR),
    'T': 15,
    'image_height': 48,
    'image_width': 64,
    'current_dir': current_dir,
    'no_goal_def': True,
}

policy = {
    'type': ClassifierController,
    'replan_interval': 15,
    'num_samples': 600,
    'selection_frac': 0.05,
    'sampler': FoldingCEMSampler,
    'initial_std': 0.005,
    'initial_std_lift': 0.05,
    'verbose_every_iter': True,
    'model_path': os.environ.get(
        'VMPC_MODEL_DIR', os.path.join(PACKAGE, 'weights', 'ag_r5f_v2')),
    'classifier_path': os.environ.get(
        'VMPC_CLASSIFIER_DIR',
        os.path.join(PACKAGE, 'weights', 'seeded_classifier')),
}

config = {
    'traj_per_file': 128,
    'current_dir': current_dir,
    'save_data': True,
    'save_raw_images': True,
    'start_index': 0,
    'end_index': int(os.environ.get('VMPC_END_INDEX', 30000)),
    'agent': agent,
    'policy': policy,
    'ngroup': 1000,
    'nshuffle': 200,
}
