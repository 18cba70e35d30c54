"""TF1 checkpoint -> flax-keyed parameter tree, and the reverse export.

The port's counterpart of ``visual_foresight_tpu/prediction/tf1_import.py``.
The reference restored pretrained TF1 SAVP/CDNA weights by matching each
model variable to the checkpoint tensor whose slash-separated name ENDS with
the variable's name parts, the first such tensor winning
(``visual_mpc/video_prediction/checkpoint_matcher.py:4-39``).  The same
suffix semantics apply here to the leaf paths of a flax-keyed numpy tree
(nested dicts, as ``models/convert.py`` writes and reads them: a
``params.npz`` holds the same tree with its keys joined by '/'), against
the tensor names of a TensorBundle read without TensorFlow
(``tf1_bundle.read_bundle``).  ``load_flax_params`` then loads the tree into
a port module.
"""

import numpy as np
import torch

from visual_foresight_torch.models.convert import unflatten_flax
from visual_foresight_torch.prediction import tf1_bundle


def leaf_paths(params, prefix=''):
    """Flatten a flax-keyed tree (nested dicts) into {slash/joined/path:
    leaf}, the leaves as they are (numpy arrays or torch tensors)."""
    flat = {}
    for key, value in params.items():
        path = prefix + str(key)
        if hasattr(value, 'items'):
            flat.update(leaf_paths(value, path + '/'))
        else:
            flat[path] = value
    return flat


def suffix_match(var_names, ckpt_names, rename=None, strict=True):
    """For each variable name find the checkpoint tensor whose name ends
    with the variable's slash-parts (reference semantics, including
    first-match-wins).  ``rename`` optionally maps variable names to
    checkpoint-side names before matching.  Returns {var_name: ckpt_name}.
    """
    out = {}
    split_ckpt = [(c, c.split('/')) for c in ckpt_names]
    for var in var_names:
        target = (rename or {}).get(var, var)
        parts = target.split('/')
        found = None
        for ck_name, ck_parts in split_ckpt:
            if ck_parts[-len(parts):] == parts:
                found = ck_name
                break
        if found is None:
            if strict:
                raise ValueError('did not find variable {}'.format(var))
            continue
        out[var] = found
    return out


def export_tf1_checkpoint(params, prefix, scope='model'):
    """Write a flax-keyed tree as a TF1 TensorBundle; leaf paths become
    slash-joined names under ``scope`` (as TF1 variable scopes named them,
    ``model/enc0/conv/kernel``)."""
    tensors = {'{}/{}'.format(scope, path): leaf
               for path, leaf in leaf_paths(params).items()}
    return tf1_bundle.write_bundle(prefix, tensors)


def _as_array(value, dtype):
    """A bundle tensor as a numpy array of ``dtype`` (a bf16 tensor is
    widened to f32 first: numpy has no bfloat16)."""
    if isinstance(value, torch.Tensor):
        value = value.float().numpy()
    return np.asarray(value).astype(dtype)


def import_tf1_checkpoint(prefix, template):
    """Load a TF1 checkpoint into the structure of ``template``, a
    flax-keyed tree of arrays.

    Each template leaf path is suffix-matched against the checkpoint's
    tensor names, strictly: a leaf that matches no tensor raises.  Shapes
    must agree exactly (conv kernels are HWIO in both TF1 and flax), and
    each tensor takes its template leaf's dtype.  Returns (tree, report):
    the tree with the template's leaves replaced by the matched tensors,
    and {'matched', 'missing', 'unused_ckpt'} as the JAX package reports
    them ('missing' is empty, since matching is strict).
    """
    available = tf1_bundle.list_variables(prefix)
    flat_template = leaf_paths(template)
    matches = suffix_match(sorted(flat_template), sorted(available))

    loaded = tf1_bundle.read_bundle(prefix, names=set(matches.values()))
    flat = dict(flat_template)
    for var, ck_name in matches.items():
        tmpl, value = flat_template[var], loaded[ck_name]
        if tuple(value.shape) != tuple(np.shape(tmpl)):
            raise ValueError(
                'shape mismatch for {} <- {}: ckpt {} vs model {}'.format(
                    var, ck_name, tuple(value.shape), np.shape(tmpl)))
        flat[var] = _as_array(value, tmpl.dtype)

    report = {
        'matched': matches,
        'missing': sorted(set(flat_template) - set(matches)),
        'unused_ckpt': sorted(set(available) - set(matches.values())),
    }
    return unflatten_flax(flat), report
