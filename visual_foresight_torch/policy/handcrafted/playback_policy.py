"""Replay pre-recorded actions from a pickle
(reference ``policy/handcrafted/playback_policy.py``).

The port's own copy of
``visual_foresight_tpu/policy/handcrafted/playback_policy.py``.
"""

import pickle as pkl

from visual_foresight_torch.policy.policy import Policy


class PlaybackPolicy(Policy):
    def __init__(self, agentparams, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = agentparams
        self._adim = agentparams['adim']
        self._pkl = None

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('file', './act.pkl')
        return parent_params

    def act(self, state, t):
        if t == 0 or self._pkl is None:
            with open(self._hp.file, 'rb') as f:
                self._pkl = pkl.load(f)
        assert 0 <= t < len(self._pkl), 'rollout longer than recording!'
        return {'actions': self._pkl[t]['actions']}
