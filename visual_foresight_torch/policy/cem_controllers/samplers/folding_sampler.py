"""Structured folding-prior CEM sampler (reference ``samplers/folding_sampler.py``).

Mixes a 5-phase pick-fold-place action prior (move/descend/grasp/move/release)
with default Gaussian samples; the structured fraction decays across refits.

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/folding_sampler.py``, drawing from the sampler's RandomState.
"""

import copy

import numpy as np

from visual_foresight_torch.policy.utils.controller_utils import (
    construct_initial_sigma)
from .cem_sampler import CEMSampler


def _ensure_psd(sigma, eps=1e-10):
    """Project a (possibly numerically indefinite) covariance to the nearest
    symmetric PSD matrix by eigenvalue clipping.  Elite-refit covariances are
    rank-deficient when the elite count is below the plan dimension, and
    principal submatrices inherit the noise — without this, multivariate
    sampling is fed a non-PSD matrix."""
    sigma = 0.5 * (sigma + sigma.T)
    w, v = np.linalg.eigh(sigma)
    if w.min() < eps:
        w = np.clip(w, eps, None)
        sigma = (v * w) @ v.T
        sigma = 0.5 * (sigma + sigma.T)
    return sigma


class FoldingCEMSampler(CEMSampler):
    def __init__(self, hp, adim, sdim, **kwargs):
        super().__init__(hp, adim, sdim, **kwargs)
        assert adim == 4, 'requires base action dimension of 4'
        assert hp.nactions >= 5, 'requires at least 5 steps'
        self._repeat = hp.repeat
        self._steps = hp.nactions
        self._base_mean, self._full_sigma, self._base_sigma = None, None, None

    def sample_initial_actions(self, t, n_samples, current_state):
        base_mean = np.zeros((self._steps * self._adim))
        base_sigma = construct_initial_sigma(self._hp, self._adim, t)
        self._current_state = current_state[:2]
        return self._sample(True, n_samples, base_mean, base_sigma)

    def sample_next_actions(self, n_samples, best_actions, scores):
        actions = best_actions.reshape(
            -1, self._hp.nactions, self._hp.repeat, self._adim)[:, :, -1, :]
        flat = actions.reshape(-1, self._hp.nactions * self._adim)
        sigma = np.cov(flat, rowvar=False, bias=False)
        mean = np.mean(flat, axis=0)
        return self._sample(False, n_samples, mean, sigma)

    def _sample(self, is_first_itr, M, new_mean, new_sigma):
        self._base_mean = copy.deepcopy(new_mean)
        self._full_sigma = _ensure_psd(np.array(new_sigma))
        self._base_sigma = _ensure_psd(self._full_sigma[:4, :4])

        ret = np.zeros((M, self._steps, self._adim))
        per_split = int((M * self._hp.split_frac) / 2)
        if is_first_itr:
            per_split = max(int(per_split / 2), 1)

        lower_sigma = copy.deepcopy(self._base_sigma)
        lower_sigma[:2, :2] /= 10
        lower_sigma[3, 3] /= 2
        lower_sigma = _ensure_psd(lower_sigma)

        def mvn(mean, sigma):
            return self._rng.multivariate_normal(mean, sigma, 1).reshape(-1)

        # split 1: full pick -> fold -> place prior
        for i in range(per_split):
            first_pnt = self._rng.uniform(size=2)
            second_pnt = self._rng.uniform(size=2)
            d1 = (first_pnt - self._current_state) / self._repeat
            d2 = (second_pnt - first_pnt) / self._repeat

            ret[i, 0] = mvn(np.array([d1[0], d1[1], 1, 0.]), self._base_sigma)
            ret[i, 1] = mvn(np.array([0, 0., -1, 0]), lower_sigma)
            ret[i, 2] = mvn(np.array([0, 0., 1, 0]), lower_sigma)
            ret[i, 3] = mvn(np.array([d2[0], d2[1], 1, 0]), self._base_sigma)
            ret[i, 4] = mvn(np.array([0, 0., -1, 0]), lower_sigma)
            for s in range(5, self._steps):
                ret[i, s] = mvn(np.zeros(4), self._base_sigma)

        # split 2: direct move -> descend prior
        for i in range(per_split, 2 * per_split):
            second_pnt = self._rng.uniform(size=2)
            d2 = (second_pnt - self._current_state) / self._repeat
            ret[i, 0] = mvn(np.array([0, 0, 1, 0.]), lower_sigma)
            ret[i, 1] = mvn(np.array([d2[0], d2[1], 1, 0]), self._base_sigma)
            ret[i, 2] = mvn(np.array([0, 0., -1, 0]), lower_sigma)
            hold = mvn(np.array([0, 0., 0, 0]), lower_sigma)
            for s in range(3, self._steps):
                ret[i, s] = hold

        # remainder: default Gaussian samples
        n_def = ret[2 * per_split:].shape[0]
        if n_def:
            default = self._rng.multivariate_normal(
                self._base_mean, self._full_sigma, n_def)
            ret[2 * per_split:] = default.reshape(
                (n_def, self._steps, self._adim))

        ret[:, :, :3] = np.clip(ret[:, :, :3],
                                -np.array(self._hp.max_shift),
                                np.array(self._hp.max_shift))
        return np.repeat(ret, self._repeat, axis=1)

    @staticmethod
    def get_default_hparams():
        return {
            'action_order': None,
            'initial_std': 0.05,
            'initial_std_lift': 0.15,
            'initial_std_rot': np.pi / 18,
            'initial_std_grasp': 2,
            'nactions': 5,
            'repeat': 3,
            'max_shift': [1. / 5, 1. / 5, 1. / 3],
            'split_frac': 0.5,
        }
