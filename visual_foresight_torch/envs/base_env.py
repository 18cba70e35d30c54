"""Environment ABI (reference ``visual_mpc/envs/base_env.py:6-112``).

Obs-dict contract: every ``step``/``reset`` returns a dict whose keys are
constant across a trajectory, numpy values keep constant shape per key, and
camera frames live under ``images`` shaped (ncam, H, W, 3) uint8.
"""

import random

import numpy as np

from visual_foresight_torch.utils.hparams import HParams


class BaseEnv:
    def step(self, action):
        """Apply action, advance simulation, return obs dict."""
        raise NotImplementedError

    def current_obs(self):
        raise NotImplementedError

    def _default_hparams(self):
        return HParams()

    def reset(self):
        """Reset environment.

        :return: (obs_dict, reset_state) where reset_state carries everything
                 needed to reproduce this initialisation (or None).
        """
        raise NotImplementedError

    def valid_rollout(self):
        """False if the rollout entered an invalid state (object fell out of
        bin, sim error, ...)."""
        raise NotImplementedError

    def goal_reached(self):
        raise NotImplementedError('Environment has no goal')

    def has_goal(self):
        return False

    def render(self):
        raise NotImplementedError('Rendering not implemented in BaseEnv')

    @property
    def adim(self):
        raise NotImplementedError

    @property
    def sdim(self):
        raise NotImplementedError

    def close(self):
        """Release any OS resources (render contexts, device handles).

        Called by the agent before a ``gen_xml`` scene regeneration replaces
        the env; default is a no-op for envs that hold nothing.
        """

    def seed(self, seed=None):
        random.seed(seed)
        np.random.seed(seed)

    def eval(self):
        """Return env statistics (distance-to-goal etc.)."""
        pass

    @staticmethod
    def default_ncam():
        """Default camera count, callable before instantiation (the agent uses
        it to infer ncam when building benchmark caches)."""
        return 2

    def save_recording(self, save_worker, i_traj):
        raise NotImplementedError
