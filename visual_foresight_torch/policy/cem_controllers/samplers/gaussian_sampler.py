"""Host-side Gaussian CEM action sampler.

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/gaussian_sampler.py``, drawing from the sampler's RandomState.  It
serves the host CEM loop and the warm-up draw before planning starts; the
fused planner draws, truncates and refits the same Gaussian on the device
(``planners/gaussian.py``).  Hparam names/defaults match the reference's
``samplers/gaussian_sampler.py`` so its experiment configs work unmodified.
"""

import numpy as np

from visual_foresight_torch.policy.utils.controller_utils import (
    construct_initial_sigma, discretize, make_blockdiagonal, reuse_cov,
    truncate_movement)
from .cem_sampler import CEMSampler


class GaussianCEMSampler(CEMSampler):
    """Multivariate Gaussian over flattened (nactions * adim) plans, refit to
    the elite set each CEM iteration.  Plans are sampled at the *decision*
    cadence and expanded by ``repeat`` to the control cadence."""

    def __init__(self, hp, adim, sdim, **kwargs):
        super().__init__(hp, adim, sdim, **kwargs)
        self._mean = None
        self._sigma = None
        self._sigma_prev = None
        self._last_reduce = None

    @staticmethod
    def get_default_hparams():
        return {
            'action_order': None,
            'initial_std': 0.05,            # xy std dev
            'initial_std_lift': 0.15,
            'initial_std_rot': np.pi / 18,
            'initial_std_grasp': 2,
            'discrete_ind': None,
            'reuse_mean': False,
            'reduce_std_dev': 1.,           # std shrink when warm-starting
            'reuse_cov': False,
            'rejection_sampling': True,
            'cov_blockdiag': False,
            'smooth_cov': False,
            'nactions': 5,
            'repeat': 3,
            'add_zero_action': False,
            'action_bound': True,
            'reuse_factor': 0.5,            # sample-count shrink on reuse
            'stochastic_planning': None,
        }

    # -- warm-start helpers ---------------------------------------------------

    def _carryover_cov(self, t):
        """True when the previous replan's covariance was shifted forward
        instead of re-initialized."""
        warm = self._hp.reuse_cov and t >= self._hp.repeat - 1 and \
            self._sigma is not None
        if warm:
            self._sigma = reuse_cov(self._sigma, self._adim, self._hp)
        else:
            self._sigma = construct_initial_sigma(self._hp, self._adim, t)
        self._sigma_prev = self._sigma
        return warm

    def _carryover_mean(self, t):
        """True when the mean was warm-started from the last best plan."""
        if not self._hp.reuse_mean or t < self._hp.repeat - 1 or \
                self._mean is None:
            self._mean = np.zeros(self._hp.nactions * self._adim)
            return False
        if self._best_action_plans[-1] is None:
            raise AssertionError(
                'cannot reuse mean without logged best actions')
        plan = self._best_action_plans[-1][0]      # control-cadence actions
        # pad to a whole number of repeat blocks, then keep one action per
        # block to get back to decision cadence
        short = plan.shape[0] % self._hp.repeat
        if short:
            plan = np.concatenate(
                [plan, np.zeros((self._hp.repeat - short, self._adim))], 0)
        per_block = plan.reshape(-1, self._hp.repeat, self._adim)[:, 0]
        mean = np.zeros((self._hp.nactions, self._adim))
        mean[:per_block.shape[0]] = per_block
        self._mean = mean.ravel()
        return True

    # -- CEMSampler interface -------------------------------------------------

    def sample_initial_actions(self, t, nsamples, current_state):
        warm_cov = self._carryover_cov(t)
        warm_mean = self._carryover_mean(t)
        self._last_reduce = warm_cov or warm_mean
        return self._sample(nsamples, self._last_reduce)

    def sample_next_actions(self, n_samples, best_actions, scores):
        self._refit(best_actions)
        return self._sample(n_samples, self._last_reduce)

    # -- internals -------------------------------------------------------------

    def _refit(self, elite_actions):
        """Refit (mean, sigma) to the elite plans at decision cadence."""
        blocks = elite_actions.reshape(
            -1, self._hp.nactions, self._hp.repeat, self._adim)
        flat = blocks[:, :, -1, :].reshape(blocks.shape[0], -1)
        sigma = np.cov(flat, rowvar=False, bias=False)
        if self._hp.cov_blockdiag:
            sigma = make_blockdiagonal(sigma, self._hp.nactions, self._adim)
        if self._hp.smooth_cov:
            sigma = (sigma + self._sigma_prev) / 2.0
            self._sigma_prev = sigma
        self._sigma = sigma
        self._mean = flat.mean(axis=0)

    def _sample(self, M, reduce_samp):
        if reduce_samp:
            M = max(int(M * self._hp.reuse_factor), 1)
        draw = self._draw_bounded if self._hp.rejection_sampling \
            else self._draw
        return draw(M)

    def _draw_raw(self, n):
        """n draws from the current Gaussian, at decision cadence."""
        flat = self._rng.multivariate_normal(self._mean, self._sigma, n)
        return flat.reshape(n, self._hp.nactions, self._adim)

    def _finalize(self, actions, M):
        """Decision-cadence plans -> control-cadence plans (+ discretize)."""
        if self._hp.stochastic_planning:
            actions = np.repeat(actions, self._hp.stochastic_planning[0], 0)
        if self._hp.discrete_ind is not None:
            actions = discretize(actions, M, self._hp.nactions,
                                 self._hp.discrete_ind)
        return np.repeat(actions, self._hp.repeat, axis=1)

    def _draw(self, M):
        actions = self._draw_raw(M)
        if self._hp.discrete_ind is not None:
            actions = discretize(actions, M, self._hp.nactions,
                                 self._hp.discrete_ind)
        if self._hp.action_bound:
            actions = truncate_movement(actions, self._hp)
        actions = np.repeat(actions, self._hp.repeat, axis=1)
        if self._hp.add_zero_action:
            actions[0] = 0
        return actions

    def _draw_bounded(self, M, max_rounds=1000):
        """Rejection sampling: keep draws whose xy (and lift, when present)
        components all fall within 1.5 sigma of zero, in vectorized rounds,
        clipping stragglers after ``max_rounds``."""
        xy_lim = 1.5 * self._hp.initial_std
        lift_lim = 1.5 * self._hp.initial_std_lift

        def in_bounds(cand):
            ok = np.all(np.abs(cand[:, :, :2]) <= xy_lim, axis=(1, 2))
            if self._adim > 2:
                ok &= np.all(np.abs(cand[:, :, 2]) <= lift_lim, axis=1)
            return ok

        kept = []
        for _ in range(max_rounds):
            need = M - len(kept)
            if need <= 0:
                break
            cand = self._draw_raw(need)
            kept.extend(cand[in_bounds(cand)])
        if len(kept) < M:
            cand = self._draw_raw(M - len(kept))
            cand[:, :, :2] = np.clip(cand[:, :, :2], -xy_lim, xy_lim)
            if self._adim > 2:
                cand[:, :, 2] = np.clip(cand[:, :, 2], -lift_lim, lift_lim)
            kept.extend(cand)
        actions = np.stack(kept[:M], axis=0)
        return self._finalize(actions, M)
