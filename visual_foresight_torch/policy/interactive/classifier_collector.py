"""Uniform random reach policy for classifier-example collection
(reference ``policy/interactive/classifier_collector.py``).

The port's own copy of
``visual_foresight_tpu/policy/interactive/classifier_collector.py``.
"""

import numpy as np

from visual_foresight_torch.policy.policy import Policy


class CollectExamplesPolicy(Policy):
    def __init__(self, agentparams, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = agentparams
        self._adim = agentparams['adim']
        assert self._adim == 5, 'only adim=5 supported'

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('floor', [0., 0., 0.1, 0.])
        parent_params.add_hparam('ceil', [1., 1., 1., 0.])
        parent_params.add_hparam('gripper_prob', 0.5)
        return parent_params

    def act(self, state, t):
        next_act = np.zeros(self._adim)
        next_act[:4] = np.random.uniform(self._hp.floor, self._hp.ceil) - \
            state[-1, :4]
        next_act[-1] = 1 if np.random.uniform() <= self._hp.gripper_prob else -1
        return {'actions': next_act}
