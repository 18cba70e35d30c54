"""Wrap any CEMSampler as a random data-collection policy
(reference ``policy/random/sampler_policy.py``).

The port's own copy of
``visual_foresight_tpu/policy/random/sampler_policy.py``.
"""

import numpy as np

from visual_foresight_torch.policy.cem_controllers.samplers.correlated_noise import (
    CorrelatedNoiseSampler)
from visual_foresight_torch.policy.policy import Policy


class SamplerPolicy(Policy):
    def __init__(self, agentparams, policyparams, gpu_id=0, ngpu=1, **kwargs):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = agentparams
        self.adim = len(self._hp.initial_std)
        self._hp.nactions = agentparams['T']
        # the global np.random stream, as the JAX policy draws (the port's
        # samplers take their generator as ``rng``)
        self._sampler = self._hp.sampler(self._hp, self.adim, None,
                                         rng=np.random)
        self._actions = None

    def _default_hparams(self):
        default_dict = {
            'nactions': None,
            'sampler': CorrelatedNoiseSampler,
            'initial_std': [0.05, 0.05, 0.2, np.pi / 10],
            'beta_0': 0.5,
            'beta_1': 0.5,
            'mean_bias': None,
            'kappa': 1,
            'smooth_across_last_action': False,
            'refit_cov': False,
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def act(self, t):
        if t == 0:
            self._actions = self._sampler.sample_initial_actions(
                t, n_samples=1, current_state=None).squeeze()
        return {'actions': self._actions[t]}
