"""MPPI-style sampler: temporally correlated noise + soft elite weighting.

Plans are built by AR(1)-filtering white noise along the time axis
(``a_t = beta_0 * eps_t + beta_1 * a_{t-1}``), and the distribution update
uses the exponentiated-reward softmax ``S = exp(kappa * (r - max r))``
instead of hard elite truncation.  Hparams match the reference's
``samplers/correlated_noise.py`` (Nagabandi et al.'s MPPI variant).

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/correlated_noise.py``, drawing from the sampler's RandomState.
"""

import numpy as np

from .cem_sampler import CEMSampler


class CorrelatedNoiseSampler(CEMSampler):
    def __init__(self, hp, adim, sdim, **kwargs):
        # adim follows the configured per-dim stds, not the env
        super().__init__(hp, len(hp.initial_std), sdim, **kwargs)

    @staticmethod
    def get_default_hparams():
        return {
            'nactions': 15,
            'initial_std': [0.05, 0.05, 0.2, np.pi / 10],
            'mean_bias': None,
            'kappa': 1,          # reward-weighting temperature
            'beta_0': 0.5,       # fresh-noise coefficient
            'beta_1': 0.5,       # carry-over coefficient
            'smooth_across_last_action': False,
            'refit_cov': False,
        }

    # -- noise generation ------------------------------------------------------

    def _white_noise(self, n, cov):
        """(n, nactions, adim) independent draws: either per-dim scaled
        normal + bias, or draws colored by an explicit covariance."""
        eps = self._rng.normal(size=(n, self._hp.nactions, self._adim))
        if cov is not None:
            return np.matmul(eps.reshape(n, -1), cov).reshape(eps.shape)
        scale = np.asarray(self._hp.initial_std).reshape(1, 1, -1)
        bias = np.zeros(self._adim) if self._hp.mean_bias is None \
            else np.asarray(self._hp.mean_bias)
        return eps * scale + bias[None, None]

    def _ar1_smooth(self, noise):
        """Filter noise along time.  Step 0 anchors on the previously
        executed action when ``smooth_across_last_action`` is set (and one
        exists); otherwise — preserving the reference's wrap-around — on the
        raw noise of the final step."""
        out = noise.copy()
        b0, b1 = self._hp.beta_0, self._hp.beta_1
        if self._hp.smooth_across_last_action and self._chosen_actions:
            anchor = self._chosen_actions[-1][None]
        else:
            anchor = noise[:, -1, :]
        out[:, 0, :] = b0 * noise[:, 0, :] + b1 * anchor
        for i in range(1, self._hp.nactions):
            out[:, i, :] = b0 * noise[:, i, :] + b1 * out[:, i - 1, :]
        return out

    # -- CEMSampler interface ----------------------------------------------------

    def sample_initial_actions(self, t, n_samples, current_state):
        return self._ar1_smooth(self._white_noise(n_samples, None))

    def sample_next_actions(self, n_samples, best_actions, scores):
        # softmax over rewards (negated costs), stabilized at max reward
        rewards = -np.asarray(scores)
        S = np.exp(self._hp.kappa * (rewards - rewards.max()))
        mean_plan = np.einsum('n,nta->ta', S, best_actions) / (S.sum() + 1e-4)

        cov = None
        if self._hp.refit_cov:
            flat = best_actions.reshape(best_actions.shape[0], -1)
            cov = np.cov(flat.T)
        fresh = self._ar1_smooth(self._white_noise(n_samples, cov))
        return fresh + mean_plan[None]
