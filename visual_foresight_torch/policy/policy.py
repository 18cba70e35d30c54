"""Policy ABI.

The port's own copy of ``visual_foresight_tpu/policy/policy.py``.
``get_policy_args`` is the agent <-> policy contract: the agent inspects the
policy's ``act`` signature and fills each keyword from the observation dict,
per-step data, or loop counters (reference ``visual_mpc/policy/policy.py:9-46``).
Policies declare typed defaults via
:class:`~visual_foresight_torch.utils.hparams.HParams` and reject overrides
that equal the default (catching stale configs, reference
``policy.py:51-66``).
"""

import abc
import inspect

import numpy as np

from visual_foresight_torch.utils.hparams import HParams


def get_policy_args(policy, obs, t, i_tr, step_data=None):
    """Build the kwargs for ``policy.act`` by reflection over its signature.

    Resolution order per argument name: obs dict -> step_data dict -> special
    names (``t``, ``i_tr``, ``obs``, ``step_data``, ``goal_pos``) -> declared
    default. Required args with no source raise.
    """
    policy_args = {}
    sig = inspect.signature(policy.act)
    for name, param in sig.parameters.items():
        if param.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            continue
        value = param.default
        if name in obs:
            value = obs[name]
        elif step_data is not None and name in step_data:
            value = step_data[name]
        elif name == 't':
            value = t
        elif name == 'i_tr':
            value = i_tr
        elif name == 'obs':
            value = obs
        elif name == 'step_data':
            value = step_data
        elif name == 'goal_pos':
            value = step_data['goal_pos']

        if value is inspect.Parameter.empty:
            raise ValueError('Required policy param {} not provided by agent'.format(name))
        policy_args[name] = value
    return policy_args


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


class DummyPolicy(object):
    """Placeholder taking the standard 4-arg policy ctor but never acting."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        pass

    def act(self, *args, **kwargs):
        pass

    def reset(self):
        pass


class NullPolicy(Policy):
    """Emits zero actions every step; useful as a hermetic test policy."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        self._adim = ag_params['adim']
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)

    def _default_hparams(self):
        params = super(NullPolicy, self)._default_hparams()
        params.add_hparam('wait_for_user', False)
        return params

    def act(self):
        return {'actions': np.zeros(self._adim)}
