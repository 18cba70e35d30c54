"""Carry flax parameters over to the port's modules.

``params_from_flax`` takes a flax parameter tree whose leaves are numpy
arrays (a caller that has JAX converts with ``jax.tree.map(np.asarray,
...)``; this module reads no checkpoint format) and returns a ``state_dict``
for :class:`models.cdna.CDNAPredictor` or any module built from
``models/layers.py``:

- a conv kernel, HWIO ``(kh, kw, in/groups, out)``, becomes OIHW; a
  depthwise ``(kh, kw, 1, C)`` kernel so becomes ``(C, 1, kh, kw)``;
- a 1x1 conv kernel ``(1, 1, in, out)`` becomes a linear ``(out, in)``
  weight, as does a dense ``(in, out)`` kernel;
- a LayerNorm's ``ln/scale`` and ``ln/bias`` become ``weight`` and ``bias``.

Any leaf it cannot place raises.  ``load_flax_params`` also raises on a
port parameter that the tree leaves unfilled.  ``params_to_flax`` is the
inverse: it turns a ``state_dict`` back into the flax tree that a
``params.npz`` holds.

A standalone network (the success classifier, the NCE embedding, the GDN,
the inverse model) is kept in its directory as the JAX trainers keep it, an
orbax ``step_<N>/`` (``prediction/checkpoints.py``), and as the port's
``params.npz``: ``restore_network`` loads the latest step directory, else
the file, else seeded weights (``seeded_state``) with a warning.  ``perturbed_flat`` makes a seeded copy
of a ``params.npz``'s arrays.
"""

import os
import warnings

import numpy as np
import torch

from visual_foresight_torch.prediction import checkpoints

PARAMS_FILE = 'params.npz'


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def params_from_flax(tree):
    """Flax parameter tree (nested dicts of numpy arrays, with or without
    the top-level ``'params'`` collection) -> torch ``state_dict``."""
    if 'params' in tree:
        tree = tree['params']
    state = {}
    for path, leaf in _flatten(tree):
        name = path[-1]
        if len(path) >= 2 and path[-2] == 'ln' and name in ('scale', 'bias'):
            key = '.'.join(path[:-2] + ('weight' if name == 'scale'
                                        else 'bias',))
            value = leaf
        elif name == 'bias':
            key, value = '.'.join(path[:-1] + ('bias',)), leaf
        elif name == 'kernel' and leaf.ndim == 2:
            key, value = '.'.join(path[:-1] + ('weight',)), leaf.T
        elif name == 'kernel' and leaf.ndim == 4 and leaf.shape[:2] == (1, 1):
            key, value = '.'.join(path[:-1] + ('weight',)), leaf[0, 0].T
        elif name == 'kernel' and leaf.ndim == 4:
            key = '.'.join(path[:-1] + ('weight',))
            value = leaf.transpose(3, 2, 0, 1)
        else:
            raise ValueError('cannot place flax leaf {} of shape {}'.format(
                '/'.join(path), leaf.shape))
        if key in state:
            raise ValueError('two flax leaves map to {}'.format(key))
        state[key] = torch.tensor(
            np.ascontiguousarray(value, dtype=np.float32))
    return state


# the flax ``nn.Dense`` layers among the port's ``nn.Linear`` modules (the
# predictor's, then the scoring, registration and inverse networks'); every
# other 2-D weight is a flax 1x1 ``nn.Conv`` kernel
DENSE_LAYERS = frozenset({'cdna_head', 'cond_proj', 'state_head', 'mu',
                          'log_var', 'fc1', 'logit', 'proj', 'head'})


def params_to_flax(state):
    """Torch ``state_dict`` -> flax tree ``{'params': ...}`` of f32 numpy
    arrays, the inverse of :func:`params_from_flax`: a 1-D ``weight`` and
    its ``bias`` are a LayerNorm's ``ln/scale`` and ``ln/bias``; a 2-D
    weight is a Dense kernel ``(in, out)`` for the layers in
    ``DENSE_LAYERS`` and a 1x1 conv kernel ``(1, 1, in, out)`` otherwise; a
    4-D weight ``(out, in/groups, kh, kw)`` is an HWIO kernel."""
    tree = {}
    for key, tensor in state.items():
        path = key.split('.')
        module, name = path[:-1], path[-1]
        value = tensor.detach().cpu().float().numpy()
        weight = state.get('.'.join(module + ['weight']))
        if weight is not None and weight.dim() == 1:        # LayerNorm
            leaf = module + ['ln', 'scale' if name == 'weight' else 'bias']
        elif name == 'bias':
            leaf = module + ['bias']
        elif name == 'weight' and value.ndim == 2:
            leaf = module + ['kernel']
            value = value.T if module[-1] in DENSE_LAYERS else \
                value.T[None, None]
        elif name == 'weight' and value.ndim == 4:
            leaf, value = module + ['kernel'], value.transpose(2, 3, 1, 0)
        else:
            raise ValueError('cannot place {} of shape {} in a flax tree'
                             .format(key, tuple(tensor.shape)))
        node = tree
        for part in leaf[:-1]:
            node = node.setdefault(part, {})
        node[leaf[-1]] = np.ascontiguousarray(value, dtype=np.float32)
    return {'params': tree}


def flatten_flax(tree):
    """Flax tree -> {'a/b/c': array}, the keys of a ``params.npz``."""
    return {'/'.join(path): leaf for path, leaf in _flatten(tree)}


def unflatten_flax(flat):
    """{'a/b/c': array} -> nested dicts, the inverse of
    :func:`flatten_flax`."""
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def load_flax_params(module, tree):
    """Load a flax tree into ``module``; raises on any flax leaf without a
    port parameter, any port parameter without a flax leaf, or any shape
    that disagrees."""
    state = params_from_flax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError('flax tree does not match the module: unfilled {}, '
                         'unconsumed {}'.format(missing, extra))
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError('{}: flax gives {}, module has {}'.format(
                key, tuple(value.shape), tuple(own[key].shape)))
    module.load_state_dict(state)
    return module


def seeded_state(module, seed=0):
    """Seeded weights for ``module``: lecun-normal-like fan-in scaling (std
    = 1/sqrt(fan_in)), zero biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, p in module.state_dict().items():
        if name.endswith('bias'):
            state[name] = torch.zeros(p.shape)
        elif p.dim() == 1:      # LayerNorm scale
            state[name] = torch.ones(p.shape)
        else:
            fan_in = int(np.prod(p.shape[1:]))
            state[name] = torch.randn(p.shape, generator=gen) / \
                np.sqrt(fan_in)
    return state


def read_npz(path):
    """{key: array} of an ``.npz`` file."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def restore_network(module, model_dir, seed=0):
    """Load ``model_dir``'s weights into ``module``, as the JAX controllers
    restore theirs: its latest ``step_<N>/`` orbax checkpoint, else its
    ``params.npz`` (a flax tree flattened with '/'-joined keys).  Where
    ``model_dir`` is empty or holds neither, warn (unless ``model_dir`` is
    empty) and load ``seeded_state(module, seed)``.  A step directory or
    file that does not load raises.  Returns whether weights were
    restored."""
    step_dir = checkpoints.latest_checkpoint(model_dir) if model_dir \
        else None
    if step_dir is not None:
        load_flax_params(module, checkpoints.restore_params(model_dir))
        print('restored {} params from {}'.format(type(module).__name__,
                                                  step_dir))
        return True
    path = os.path.join(str(model_dir), PARAMS_FILE) if model_dir else None
    if path and os.path.isfile(path):
        load_flax_params(module, unflatten_flax(read_npz(path)))
        print('restored {} params from {}'.format(type(module).__name__,
                                                  path))
        return True
    if path:
        warnings.warn('no checkpoint or numpy params in {}; {} on seeded '
                      'random weights'.format(model_dir,
                                              type(module).__name__))
    module.load_state_dict(seeded_state(module, seed))
    return False


def perturbed_flat(flat, seed, scale, floor=0.0):
    """A copy of ``flat`` ({key: f32 array}) with seeded normal noise added
    to every array, keys taken in sorted order: its std is ``scale`` times
    the array's own std, or times ``floor`` where that is larger (so that a
    constant array such as a zero bias moves too)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(flat):
        x = np.asarray(flat[k], np.float32)
        std = np.float32(scale * max(float(x.std()), floor))
        out[k] = (x + rng.randn(*x.shape).astype(np.float32) * std).astype(
            np.float32)
    return out
