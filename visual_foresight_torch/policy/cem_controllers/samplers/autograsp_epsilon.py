"""Epsilon-greedy autograsp sampler (reference ``samplers/autograsp_epsilon.py``,
modernized to the current CEMSampler ctor — the reference version had drifted
to an older constructor signature).

A decaying fraction of samples per CEM iteration gets autograsp gripper
commands derived from cumulative z motion, each flipped with probability
``ag_epsilon`` for grasp exploration.

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/autograsp_epsilon.py``, drawing from the sampler's RandomState.
"""

import numpy as np

from visual_foresight_torch.policy.utils.controller_utils import (
    construct_initial_sigma, truncate_movement)
from .cem_sampler import CEMSampler


class AutograspEpsilon(CEMSampler):
    def __init__(self, hp, adim, sdim, **kwargs):
        super().__init__(hp, adim, sdim, **kwargs)
        assert 0 <= self._hp.base_frac <= 1
        assert 0 <= self._hp.base_frac_reduce < 1
        assert 0 <= self._hp.ag_epsilon <= 1

        z_dim, gripper_dim = 2, adim - 1
        if self._hp.action_order is not None:
            assert 'z' in self._hp.action_order and \
                'grasp' in self._hp.action_order, \
                'AG epsilon requires z and grasp dims'
            for i, a in enumerate(self._hp.action_order):
                if a == 'grasp':
                    gripper_dim = i
                elif a == 'z':
                    z_dim = i
        self._z_dim, self._gripper_dim = z_dim, gripper_dim
        self._itr = 0
        self._mean = np.zeros(self._hp.nactions * adim)
        self._sigma = construct_initial_sigma(self._hp, adim)

    def _default_sampler(self, mean, sigma, M):
        actions = self._rng.multivariate_normal(mean, sigma, M)
        actions = actions.reshape(M, self._hp.nactions, self._adim)
        if self._hp.action_bound:
            actions = truncate_movement(actions, self._hp)
        return np.repeat(actions, self._hp.repeat, axis=1)

    def _apply_ag_epsilon(self, state, actions, close_override=False):
        cum_z = np.cumsum(actions[:, :, self._z_dim] / self._hp.z_norm, 1) + \
            state[self._z_dim]
        z_check = (cum_z <= self._hp.ag_zthresh).astype(np.float32) * 2 - 1
        first_close = np.argmax(z_check, axis=1)
        if close_override:
            actions[:, :, self._gripper_dim] = 1
        else:
            for i, p in enumerate(first_close):
                pivot = p - p % self._hp.repeat  # flip on repeat boundaries
                actions[i, :pivot, self._gripper_dim] = -1
                actions[i, pivot:, self._gripper_dim] = 1
        eps = self._rng.choice([-1, 1], size=actions.shape[:-1],
                               p=[self._hp.ag_epsilon, 1 - self._hp.ag_epsilon])
        actions[:, :, self._gripper_dim] *= eps

    def sample_initial_actions(self, t, nsamples, current_state):
        self._itr = 0
        self._state = np.asarray(current_state)
        return self._sample(nsamples)

    def sample_next_actions(self, n_samples, best_actions, scores):
        acts = best_actions.reshape(
            -1, self._hp.nactions, self._hp.repeat, self._adim)[:, :, -1, :]
        flat = acts.reshape(-1, self._hp.nactions * self._adim)
        self._sigma = np.cov(flat, rowvar=False, bias=False)
        self._mean = np.mean(flat, axis=0)
        self._itr += 1
        return self._sample(n_samples)

    def _sample(self, M):
        apply_amount = max(
            int(M * self._hp.base_frac *
                (self._hp.base_frac_reduce ** self._itr)), 1)
        actions = self._default_sampler(self._mean, self._sigma, M)
        self._apply_ag_epsilon(self._state, actions[:apply_amount])
        return actions

    @staticmethod
    def get_default_hparams():
        from .gaussian_sampler import GaussianCEMSampler
        parent = GaussianCEMSampler.get_default_hparams()
        parent.update({
            'ag_zthresh': 1. / 3,
            'ag_epsilon': 0.5,
            'z_norm': 1,
            'base_frac': 1,
            'base_frac_reduce': 0.3,
        })
        return parent
