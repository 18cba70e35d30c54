"""Stand-in weights for the campaign twins whose sources name trained
weights that the repo does not hold.

A twin asks for its default weights here when no ``VMPC_*`` variable names
them.  Each function warns (``UserWarning``) with the name of the trained
weights it stands in for, and returns a directory:

- ``vendored``: a numpy export of ``visual_foresight_torch/weights/`` as
  it is (``ag_r5f_v2`` for ``ag_r5f_v1``, ``seeded_nce`` for an NCE
  embedding, ...);
- ``noisy_copy``: a predictor export plus seeded noise
  (``models/convert.py::perturbed_flat`` at ``COPY_SCALE``), one view: an
  ensemble member;
- ``second_view``: a two-view predictor, ``view0/`` the export and
  ``view1/`` its noisy copy: a two-camera model;
- ``inverse_net``: the port's seeded init of ``models/inverse.py`` at
  ``ag_bench20_inverse``'s widths, with its ``net_config.json``.

The written ones go under ``build/stand_ins/<name>/`` of the checkout,
once: each is filled in a temporary directory beside it and moved into
place with ``os.replace``, so that processes loading the twins at the same
time (test workers, campaign workers) each find a whole directory.  The
name holds every input of the bytes (the seed, the scale, the first 12 hex
digits of the source ``params.npz``'s SHA-256; the inverse net's widths and
seed), so a changed input writes a new directory and never reuses an old
one.
"""

import functools
import hashlib
import json
import os
import shutil
import tempfile
import warnings

import numpy as np

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(PACKAGE, 'weights')
ROOT = os.path.join(os.path.dirname(PACKAGE), 'build', 'stand_ins')
# the noise of a copy, relative to each array's own std
COPY_SCALE = 0.1
# ag_bench20_inverse's net: InverseNet(adim, plan_T, num_context), seeded
INVERSE_ADIM, INVERSE_PLAN_T, INVERSE_CONTEXT = 4, 7, 2
INVERSE_SEED = 54
PARAMS = 'params.npz'


def _warn(trained, path):
    warnings.warn('no trained weights {} in the repo: standing in with {}'
                  .format(trained, path), UserWarning, stacklevel=3)
    return path


def _write_once(name, fill):
    """``ROOT/name``, filled by ``fill(directory)`` unless it is there."""
    path = os.path.join(ROOT, name)
    if os.path.isdir(path):
        return path
    os.makedirs(ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='.' + name + '.', dir=ROOT)
    try:
        fill(tmp)
        os.replace(tmp, path)
    except OSError:
        if not os.path.isdir(path):
            raise
    finally:
        if os.path.isdir(tmp):          # another process placed it first
            shutil.rmtree(tmp)
    return path


def _write_views(root, base, views):
    for v, flat in enumerate(views):
        os.makedirs(os.path.join(root, 'view{}'.format(v)))
        np.savez(os.path.join(root, 'view{}'.format(v), PARAMS), **flat)
    shutil.copyfile(os.path.join(WEIGHTS, base, 'model_config.json'),
                    os.path.join(root, 'model_config.json'))


def _source(base):
    return os.path.join(WEIGHTS, base, 'view0', PARAMS)


@functools.lru_cache(maxsize=None)
def _digest(path):
    """The first 12 hex digits of the SHA-256 of the file at ``path``."""
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(1 << 20), b''):
            h.update(block)
    return h.hexdigest()[:12]


def _copy_name(base, kind, seed):
    return '{}{}_s{}_x{}_{}'.format(base, kind, seed, COPY_SCALE,
                                    _digest(_source(base)))


def _flat(base):
    from visual_foresight_torch.models.convert import read_npz
    return read_npz(_source(base))


def copy_views(base, seeds):
    """The views of ``base``'s noisy copies, one a seed (no file written)."""
    from visual_foresight_torch.models.convert import perturbed_flat
    flat = _flat(base)
    return [perturbed_flat(flat, int(s), COPY_SCALE) for s in seeds]


def vendored(name, trained):
    """The vendored export ``weights/<name>``, standing in for
    ``trained``."""
    return _warn(trained, os.path.join(WEIGHTS, name))


def noisy_copy(base, seed, trained):
    """``base``'s one view plus seeded noise:
    ``<base>_s<seed>_x<COPY_SCALE>_<digest>/``."""
    path = _write_once(_copy_name(base, '', seed), lambda d: _write_views(
        d, base, copy_views(base, (seed,))))
    return _warn(trained, path)


def second_view(base, seed, trained):
    """A two-view predictor: ``base``, then its copy under ``seed``:
    ``<base>_2view_s<seed>_x<COPY_SCALE>_<digest>/``."""
    path = _write_once(_copy_name(base, '_2view', seed),
                       lambda d: _write_views(d, base, [_flat(base)] +
                                              copy_views(base, (seed,))))
    return _warn(trained, path)


def inverse_net(trained):
    """The port's ``InverseNet(INVERSE_ADIM, INVERSE_PLAN_T,
    INVERSE_CONTEXT)`` under ``seeded_state`` (seed ``INVERSE_SEED``):
    ``inverse_a4_t7_c2_s54/``."""
    shape = {'adim': INVERSE_ADIM, 'plan_T': INVERSE_PLAN_T,
             'num_context': INVERSE_CONTEXT}

    def fill(d):
        from visual_foresight_torch.models.convert import (
            flatten_flax, params_to_flax, seeded_state)
        from visual_foresight_torch.models.inverse import InverseNet
        net = InverseNet(INVERSE_ADIM, INVERSE_PLAN_T, INVERSE_CONTEXT)
        np.savez(os.path.join(d, PARAMS), **flatten_flax(
            params_to_flax(seeded_state(net, INVERSE_SEED))))
        with open(os.path.join(d, 'net_config.json'), 'w') as f:
            json.dump(shape, f, indent=1)
    path = _write_once('inverse_a{adim}_t{plan_T}_c{num_context}_s{}'.format(
        INVERSE_SEED, **shape), fill)
    return _warn(trained, path)
