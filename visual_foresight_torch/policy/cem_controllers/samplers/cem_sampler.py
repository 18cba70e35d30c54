"""CEM sampler interface (reference ``samplers/cem_sampler.py``).

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/cem_sampler.py``.  The host draws of every sampler come from the
``np.random.RandomState`` given as ``rng`` (the controller's, seeded from
its ``seed`` hparam), never from the global ``np.random``; a RandomState
seeded with ``s`` gives the stream that ``np.random.seed(s)`` gives the JAX
package's samplers.
"""

import numpy as np


class CEMSampler(object):
    def __init__(self, hp, adim, sdim, rng=None, **kwargs):
        self._hp = hp
        self._adim, self._sdim = adim, sdim
        self._rng = np.random.RandomState(0) if rng is None else rng
        self._chosen_actions = []
        self._best_action_plans = []

    def sample_initial_actions(self, t, nsamples, current_state):
        """:return: (B, T, adim) action samples for the first CEM iteration"""
        raise NotImplementedError

    def sample_next_actions(self, n_samples, best_actions, scores):
        """:return: (B, T, adim) samples refit to the given elites"""
        raise NotImplementedError

    def log_best_action(self, action, best_action_plans):
        """Record the executed action and the remaining best plans (some
        samplers condition future sampling on them)."""
        self._chosen_actions.append(action.copy())
        self._best_action_plans.append(best_action_plans)

    @property
    def chosen_actions(self):
        """(t, adim) actions executed so far this trajectory."""
        return np.array(self._chosen_actions)

    @property
    def best_action_plans(self):
        """Per-step log of the elites' remaining control-cadence actions
        (entry shape (K, remaining, adim)); warm starts read [-1][0]."""
        return self._best_action_plans

    @staticmethod
    def get_default_hparams():
        return {}
