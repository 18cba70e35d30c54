"""Policy base class: typed default hparams and override checking.

The port's own copy of ``Policy`` from ``visual_foresight_tpu/policy/
policy.py``.  Policies declare typed defaults via
:class:`~visual_foresight_torch.utils.hparams.HParams` and reject overrides
that equal the default (catching stale configs, reference
``policy.py:51-66``).
"""

import abc

import numpy as np

from visual_foresight_torch.utils.hparams import HParams


class Policy(object, metaclass=abc.ABCMeta):
    def _override_defaults(self, policyparams):
        for name, value in policyparams.items():
            if name == 'type':
                continue  # 'type' holds the policy class itself
            default = getattr(self._hp, name) if name in self._hp else None
            # the identical-to-default error catches stale configs (reference
            # ``policy.py:57-58``); empty-ish defaults are exempt so configs
            # can set paths/lists programmatically
            if name in self._hp and default not in (None, '', [], {}) and \
                    np.all(value == default):
                raise ValueError(
                    'Policy param {} override is identical to its default!'.format(name))
            if name in self._hp and default is None:
                setattr(self._hp, name, value)  # no type check on None defaults
            else:
                self._hp.set_hparam(name, value)

    def _default_hparams(self):
        return HParams()

    @abc.abstractmethod
    def act(self, *args, **kwargs):
        """Return dict with at least an 'actions' key holding this step's action."""
        raise NotImplementedError

    def reset(self):
        pass
