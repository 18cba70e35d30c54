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
  ``ag_bench20_inverse``'s widths, with its ``net_config.json``;
- ``seeded_predictor``: the port's seeded init of a predictor at the
  flagship's widths (``weights/xz_flagship/model_config.json``) at another
  image size and other action and state widths, one view a seed: a
  96x128 sawyer model, whose CDNA kernel head (a dense layer over the
  flattened top encoder map) no 48x64 export can fill;
- ``gdn_net``: the port's seeded init of ``models/gdn.py`` at its default
  widths, with its ``net_config.json``.

The written ones go under ``build/stand_ins/<name>/`` of the checkout,
once: each is filled in a temporary directory beside it and moved into
place with ``os.replace``, so that processes loading the twins at the same
time (test workers, campaign workers) each find a whole directory.  The
name holds every input of the bytes (the seed, the scale, the first 12 hex
digits of the source ``params.npz``'s SHA-256; a seeded net's widths,
image size and seeds), so a changed input writes a new directory and
never reuses an old one.
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
# the sawyer registration experiment's predictor: the flagship's widths at
# 96x128 with the robot env's 4 actions and 5 states, two views
REG_IMG_DIMS, REG_ADIM, REG_SDIM = (96, 128), 4, 5
REG_VIEW_SEEDS = (61, 62)
GDN_SEED = 63
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


def seeded_predictor(img_dims, adim, sdim, seeds, trained):
    """The port's ``CDNAPredictor`` at the flagship's widths, ``img_dims``,
    ``adim`` and ``sdim``, under ``seeded_state`` with one seed a view
    (``view<i>/`` for ``seeds[i]``), beside its ``model_config.json``:
    ``flagship_<H>x<W>_a<adim>_s<sdim>_v<seeds joined by ->/``."""
    with open(os.path.join(WEIGHTS, 'xz_flagship', 'model_config.json')) as f:
        config = dict(json.load(f), adim=int(adim), sdim=int(sdim),
                      img_dims=[int(d) for d in img_dims])

    def fill(d):
        import torch
        from visual_foresight_torch.models.cdna import CDNAPredictor
        from visual_foresight_torch.models.convert import (
            flatten_flax, params_to_flax, seeded_state)
        model = CDNAPredictor(
            tuple(config['img_dims']), n_context=config['context_frames'],
            num_masks=config['num_masks'], kernel_size=config['kernel_size'],
            sna=config['sna'], dna=config['dna'], sdim=config['sdim'],
            adim=config['adim'], dtype=torch.float32,
            enc_features=tuple(config['enc_features']),
            lstm_kernel=config['lstm_kernel'],
            separable_lstm=config['separable_lstm'],
            std_factor=config['std_factor'],
            latent_dim=config['latent_dim'])
        views = [flatten_flax(params_to_flax(seeded_state(model, int(s))))
                 for s in seeds]
        for v, flat in enumerate(views):
            os.makedirs(os.path.join(d, 'view{}'.format(v)))
            np.savez(os.path.join(d, 'view{}'.format(v), PARAMS), **flat)
        with open(os.path.join(d, 'model_config.json'), 'w') as f:
            json.dump(config, f, indent=1)
    path = _write_once('flagship_{}x{}_a{}_s{}_v{}'.format(
        config['img_dims'][0], config['img_dims'][1], config['adim'],
        config['sdim'], '-'.join(str(int(s)) for s in seeds)), fill)
    return _warn(trained, path)


def gdn_net(trained):
    """The port's ``GoalDistanceNet()`` under ``seeded_state`` (seed
    ``GDN_SEED``): ``gdn_f<features joined by ->_s<seed>/``."""
    from visual_foresight_torch.models import gdn
    shape = {'features': list(gdn.FEATURES), 'flow_scale': 10.0}

    def fill(d):
        from visual_foresight_torch.models.convert import (
            flatten_flax, params_to_flax, seeded_state)
        net = gdn.GoalDistanceNet(tuple(shape['features']),
                                  shape['flow_scale'])
        np.savez(os.path.join(d, PARAMS), **flatten_flax(
            params_to_flax(seeded_state(net, GDN_SEED))))
        with open(os.path.join(d, 'net_config.json'), 'w') as f:
            json.dump(shape, f, indent=1)
    path = _write_once('gdn_f{}_s{}'.format(
        '-'.join(str(f) for f in shape['features']), GDN_SEED), fill)
    return _warn(trained, path)
