"""Typed hyper-parameter container.

The port's own copy of ``visual_foresight_tpu/utils/hparams.py``: that
package imports JAX when any of its modules is imported, so the port keeps
its own.

The reference framework leans on ``tf.contrib.training.HParams`` for every
policy/env/sampler default table (see reference ``visual_mpc/policy/policy.py:51-66``
and ``visual_mpc/envs/base_env.py:25``).  TF1 does not exist on this stack, so we
provide a small, dependency-free clone with identical semantics:

- ``add_hparam(name, value)``  — declare a new parameter (errors on redefine)
- ``set_hparam(name, value)``  — override an existing parameter with type checking
- ``values()``, ``get(name, default)``, ``in`` operator, attribute access
- ``override_from_dict(dict)`` — bulk override (used by the dataset reader)

Type checking follows the TF1 behaviour: ints may widen to floats, ``None``
defaults accept anything, and list-typed params require list overrides.
"""

import numpy as np


class HParams(object):
    def __init__(self, **kwargs):
        object.__setattr__(self, '_params', {})
        for name, value in kwargs.items():
            self.add_hparam(name, value)

    # -- declaration / override ------------------------------------------------
    def add_hparam(self, name, value):
        if name in self._params:
            raise ValueError('Hyperparameter {} already defined'.format(name))
        self._params[name] = value

    def set_hparam(self, name, value):
        if name not in self._params:
            raise KeyError('Hyperparameter {} not defined; use add_hparam'.format(name))
        old = self._params[name]
        self._params[name] = self._check_type(name, old, value)

    def override_from_dict(self, values):
        for name, value in values.items():
            self.set_hparam(name, value)
        return self

    @staticmethod
    def _check_type(name, old, new):
        if old is None or new is None:
            return new
        if isinstance(old, bool):
            if not isinstance(new, (bool, np.bool_)):
                raise ValueError('Param {} expects bool, got {!r}'.format(name, new))
            return bool(new)
        if isinstance(old, (int, np.integer)) and not isinstance(old, bool):
            if isinstance(new, (bool,)):
                raise ValueError('Param {} expects number, got bool'.format(name))
            if isinstance(new, (int, np.integer)):
                return int(new)
            if isinstance(new, (float, np.floating)):
                return new  # int defaults may be overridden by floats (TF1 allowed widening)
            raise ValueError('Param {} expects number, got {!r}'.format(name, new))
        if isinstance(old, (float, np.floating)):
            if isinstance(new, (int, float, np.integer, np.floating)) and not isinstance(new, bool):
                return float(new)
            raise ValueError('Param {} expects float, got {!r}'.format(name, new))
        if isinstance(old, str):
            if not isinstance(new, str):
                raise ValueError('Param {} expects str, got {!r}'.format(name, new))
            return new
        # lists / arrays / classes / callables: accept as-is
        return new

    # -- access ------------------------------------------------------------------
    def values(self):
        return dict(self._params)

    def get(self, name, default=None):
        return self._params.get(name, default)

    def __contains__(self, name):
        return name in self._params

    def __getattr__(self, name):
        params = object.__getattribute__(self, '_params')
        if name in params:
            return params[name]
        raise AttributeError('No hyperparameter named {}'.format(name))

    def __setattr__(self, name, value):
        if name.startswith('_'):
            object.__setattr__(self, name, value)
        else:
            self._params[name] = value

    def __repr__(self):
        return 'HParams({})'.format(
            ', '.join('{}={!r}'.format(k, v) for k, v in sorted(self._params.items(),
                                                                key=lambda kv: kv[0])))
