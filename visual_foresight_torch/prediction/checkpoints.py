"""Checkpoint save and restore for parameter trees, in the JAX package's
orbax layout, with numpy alone.

The port's twin of ``visual_foresight_tpu/prediction/checkpoints.py``, with
its names and its answers.  A checkpoint is a step directory
``<model_dir>/step_<N>/`` as orbax's ``StandardCheckpointer`` writes it:

- ``_CHECKPOINT_METADATA`` and ``_METADATA`` (JSON); the latter's
  ``tree_metadata`` gives every leaf's key tuple with each key's type
  (``key_type`` 1 for a sequence index, a tuple's or a namedtuple's; 2 for
  a dict key) and whether the leaf holds an array (``np.ndarray``) or is
  ``None`` (an optax ``EmptyState`` and the like);
- an OCDBT store (``utils/ocdbt.py``) holding one zarr v2 array a leaf
  (``utils/zarr.py``), named by the leaf's keys joined with ``.``.

``restore_params`` reads it with the port's own OCDBT reader and zstd
decoder (``native/zstd_decode.cpp``) and returns nested dicts and lists of
numpy arrays (a bfloat16 leaf as a ``torch.bfloat16`` tensor), built from
the key tuples and their types, never by splitting names on ``.``.
``save_params`` writes the same layout, uncompressed, and orbax restores it.
``latest_checkpoint`` reproduces the reference's latest-iteration glob
(``setup_predictor.py:12-28``), ``suffix_match_restore`` its name-drift-
tolerant matcher (``checkpoint_matcher.py:4-39``).
"""

import glob as globlib
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from visual_foresight_torch.utils import ocdbt, zarr

CHECKPOINT_METADATA = '_CHECKPOINT_METADATA'
METADATA = '_METADATA'
HANDLER = ('orbax.checkpoint._src.handlers.standard_checkpoint_handler.'
           'StandardCheckpointHandler')
KEY_SEQUENCE, KEY_DICT = 1, 2


def _ckpt_dir(path):
    return os.path.abspath(str(path))


def latest_checkpoint(model_dir):
    """The highest-step checkpoint subdir ``step_<N>`` under ``model_dir``,
    or None (analog of ``get_maxiter_weights``,
    ``setup_predictor.py:12-28``)."""
    model_dir = _ckpt_dir(model_dir)
    if not os.path.isdir(model_dir):
        return None
    steps = []
    for name in os.listdir(model_dir):
        m = re.match(r'^step_(\d+)$', name)
        if m:
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(model_dir, 'step_{}'.format(max(steps)))


def resolve_model_dir(candidates, view='view0'):
    """The first candidate dir holding a restorable checkpoint under
    ``view``: a ``step_<N>`` directory (``latest_checkpoint``) or a TF1
    ``*.index`` bundle.  None where no candidate has one."""
    for cand in candidates:
        view_dir = os.path.join(str(cand), view)
        try:
            if latest_checkpoint(view_dir) is not None:
                return cand
            if globlib.glob(os.path.join(view_dir, '*.index')):
                return cand
        except Exception:
            continue
    return None


def _step_path(model_dir, step):
    if step is not None:
        return os.path.join(_ckpt_dir(model_dir), 'step_{}'.format(step))
    return latest_checkpoint(model_dir)


def _leaves(tree, path=()):
    """(key tuple, key types, leaf) of every leaf of a tree of dicts, lists,
    tuples and namedtuples, in the order JAX flattens it (dict keys
    sorted)."""
    if isinstance(tree, dict) or (hasattr(tree, 'items') and
                                  not isinstance(tree, torch.Tensor)):
        for key in sorted(tree, key=str):
            for p, t, leaf in _leaves(tree[key], path + ((str(key),
                                                          KEY_DICT),)):
                yield p, t, leaf
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + ((str(i), KEY_SEQUENCE),))
    else:
        yield tuple(k for k, _ in path), tuple(t for _, t in path), tree


def save_params(params, model_dir, step):
    """Write ``params`` (nested dicts, lists and tuples of numpy arrays,
    scalars or tensors; None for an empty leaf) as ``step_<step>/`` under
    ``model_dir``, replacing one that exists; returns its path."""
    path = os.path.join(_ckpt_dir(model_dir), 'step_{}'.format(step))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = '{}.tmp{}'.format(path, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    started = time.time_ns()
    tree_metadata, items = {}, {}
    for keys, types, leaf in _leaves(params):
        if not keys:
            raise ValueError('save_params needs a tree, got a bare leaf')
        entry = {'key_metadata': [{'key': k, 'key_type': t}
                                  for k, t in zip(keys, types)]}
        if leaf is None:
            entry['value_metadata'] = {'value_type': 'None',
                                       'skip_deserialize': True}
        else:
            entry['value_metadata'] = {'value_type': 'np.ndarray',
                                       'skip_deserialize': False}
            items.update(zarr.encode_array('.'.join(keys), leaf))
        tree_metadata[repr(keys)] = entry
    ocdbt.write_store(tmp, items)
    with open(os.path.join(tmp, METADATA), 'w') as f:
        json.dump({'tree_metadata': tree_metadata, 'use_ocdbt': True,
                   'use_zarr3': False,
                   'store_array_data_equal_to_fill_value': True,
                   'custom_metadata': None}, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), 'w') as f:
        json.dump({'item_handlers': HANDLER, 'metrics': {},
                   'performance_metrics': {},
                   'init_timestamp_nsecs': started,
                   'commit_timestamp_nsecs': time.time_ns(),
                   'custom_metadata': {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def _insert(tree, key_metadata, value, where):
    """Put ``value`` into ``tree`` (a dict, or a dict of index -> node for
    a sequence) along the key metadata."""
    node = tree
    for i, entry in enumerate(key_metadata):
        key, kind = entry['key'], entry['key_type']
        if kind == KEY_SEQUENCE:
            key = int(key)
        elif kind != KEY_DICT:
            raise ValueError('{}: key type {}'.format(where, kind))
        if i + 1 == len(key_metadata):
            node[key] = value
            return
        nxt = key_metadata[i + 1]['key_type']
        child = node.setdefault(key, ({}, nxt))
        if child[1] != nxt:
            raise ValueError('{}: keys of mixed types'.format(where))
        node = child[0]


def _finish(node):
    """Turn the ``(children, key type)`` pairs of ``_insert`` into dicts
    and lists."""
    if isinstance(node, tuple):
        children, kind = node
        if kind == KEY_SEQUENCE:
            if sorted(children) != list(range(len(children))):
                raise ValueError('sequence indices {} have gaps'.format(
                    sorted(children)))
            return [_finish(children[i]) for i in range(len(children))]
        return {k: _finish(v) for k, v in children.items()}
    return node


def restore_params(model_dir, template=None, step=None):
    """The latest (or the given step's) parameter tree under
    ``model_dir``: nested dicts and lists of numpy arrays.  Raises
    FileNotFoundError where no step exists, ValueError where it does not
    read or, given a ``template``, where a leaf's path, shape or dtype
    differs from the template's."""
    path = _step_path(model_dir, step)
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError('no checkpoints under {}'.format(model_dir))
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError('{}: no {}'.format(path, METADATA))
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt', False) or meta.get('use_zarr3', False):
        raise ValueError('{}: only OCDBT with zarr v2 is supported'.format(
            path))
    store = ocdbt.OcdbtReader(path)
    root = ({}, None)
    for name, entry in meta['tree_metadata'].items():
        keys = entry['key_metadata']
        if not keys:
            raise ValueError('{}: a leaf without keys'.format(path))
        if root[1] is None:
            root = ({}, keys[0]['key_type'])
        elif root[1] != keys[0]['key_type']:
            raise ValueError('{}: top-level keys of mixed types'.format(path))
        value_meta = entry.get('value_metadata', {})
        if value_meta.get('skip_deserialize'):
            value = None
        else:
            value = zarr.read_array(store, '.'.join(k['key'] for k in keys))
        _insert(root[0], keys, value, '{} {}'.format(path, name))
    tree = _finish(root) if root[1] is not None else {}
    if template is not None:
        _check_against(tree, template, path)
    return tree


def _describe(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace('torch.', '')
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype.name


def _check_against(tree, template, where='checkpoint'):
    """Raise ValueError unless ``tree`` has the leaves of ``template`` (by
    path), each of the template's shape and dtype."""
    got = {keys: leaf for keys, _, leaf in _leaves(tree)}
    want = {keys: leaf for keys, _, leaf in _leaves(template)}
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        raise ValueError('{}: leaves differ from the template (missing {}, '
                         'unexpected {})'.format(where, missing[:5],
                                                 extra[:5]))
    for keys, leaf in want.items():
        if leaf is None or got[keys] is None:
            if (leaf is None) != (got[keys] is None):
                raise ValueError('{}: {} is None on one side only'.format(
                    where, '.'.join(keys)))
            continue
        if _describe(leaf) != _describe(got[keys]):
            raise ValueError('{}: {} is {}, the template has {}'.format(
                where, '.'.join(keys), _describe(got[keys]),
                _describe(leaf)))


def _flatten_with_names(params):
    """{'a/b/0': leaf} of a tree, the names ``suffix_match_restore``
    matches on."""
    return {'/'.join(keys): leaf for keys, _, leaf in _leaves(params)}


def suffix_match_restore(source_params, target_template):
    """Map the leaves of ``source_params`` onto ``target_template``: each
    target leaf takes the first source leaf whose '/'-joined path is a
    suffix of its own or has its own as a suffix, with the same shape
    (analog of ``variable_checkpoint_matcher``,
    ``checkpoint_matcher.py:4-39``).  Unmatched target leaves keep their
    template values.  Returns a tree of the target's structure."""
    src = _flatten_with_names(source_params)

    def match(node, path):
        if isinstance(node, dict):
            return {k: match(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [match(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(out) if not hasattr(node, '_fields') else \
                type(node)(*out)
        name = '/'.join(path)
        for src_name, src_leaf in src.items():
            if (name.endswith(src_name) or src_name.endswith(name)) and \
                    np.shape(src_leaf) == np.shape(node):
                return src_leaf
        return node

    return match(target_template, ())
