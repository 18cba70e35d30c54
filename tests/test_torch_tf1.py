"""Port parity: the TF1 TensorBundle codec and checkpoint import
(``visual_foresight_torch/prediction/tf1_bundle.py``, ``tf1_import.py``)
against the JAX package's, and ``TorchPredictor.restore`` serving a TF1
bundle.

- ``write_bundle`` writes the same bytes (index and data shard) as JAX's for
  the same tensors, in every dtype of ``_DTYPES`` (bf16 from a
  ``torch.bfloat16`` tensor on the port's side, an ``ml_dtypes`` array on
  JAX's); each package reads the other's bundle.
- A flipped byte in the data shard or the index raises in both packages,
  under both of the port's CRC32C implementations.
- ``suffix_match`` equals JAX's on the cases of ``tests/test_tf1_import.py``;
  a shape mismatch raises.
- The repair: a view directory holding JAX-exported bundles (two steps; the
  higher one is served) restores into ``TorchPredictor`` (``restored``
  true), which then predicts what ``TPUPredictor`` predicts on the same
  directory within 1e-5 (f32, the classic backbone at 16x16).
- The flagship's ``params.npz`` through export and import gives the same
  arrays, and the predictor restored from the bundle the same state as the
  one restored from the file.
"""

import json
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.data import tfrecord_io
from visual_foresight_torch.models.convert import (params_to_flax, read_npz,
                                                   unflatten_flax)
from visual_foresight_torch.prediction import tf1_bundle as t_bundle
from visual_foresight_torch.prediction import tf1_import as t_import
from visual_foresight_torch.prediction.predictor import TorchPredictor
from visual_foresight_tpu.prediction import tf1_bundle as j_bundle
from visual_foresight_tpu.prediction import tf1_import as j_import
from visual_foresight_tpu.prediction.predictor import TPUPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                        'xz_flagship')
TOL = 1e-5


def _tensors(code):
    """Three tensors of the dtype with TF code ``code`` (a 0-d scalar among
    them): the JAX side's numpy arrays and the port side's (bf16 as a torch
    tensor with the same bits)."""
    rng = np.random.RandomState(code)
    dt = j_bundle._DTYPES[code]
    shapes = {'model/enc0/kernel': (3, 3, 2, 4), 'model/enc0/bias': (4,),
              'scalar': ()}
    jax_side, port_side = {}, {}
    for name, shape in shapes.items():
        if code == 14:
            arr = np.asarray(rng.randn(*shape)).astype(ml_dtypes.bfloat16)
            jax_side[name] = arr
            port_side[name] = torch.from_numpy(
                arr.view(np.int16).copy()).view(
                    torch.bfloat16)
        else:
            if dt.kind == 'b':
                arr = rng.rand(*shape) > 0.5
            elif dt.kind in 'iu':
                info = np.iinfo(dt)
                arr = rng.randint(max(info.min, -1000), min(info.max, 1000),
                                  shape)
            else:
                arr = rng.randn(*shape)
            jax_side[name] = port_side[name] = np.asarray(arr).astype(dt)
    return jax_side, port_side


def _files(prefix):
    return {s: open(prefix + s, 'rb').read()
            for s in ('.index', '.data-00000-of-00001')}


@pytest.mark.parametrize('code', sorted(j_bundle._DTYPES))
def test_write_bundle_writes_what_jax_writes(tmp_path, code):
    jax_side, port_side = _tensors(code)
    j_bundle.write_bundle(str(tmp_path / 'jax' / 'model-1'), jax_side)
    t_bundle.write_bundle(str(tmp_path / 'port' / 'model-1'), port_side)
    assert _files(str(tmp_path / 'port' / 'model-1')) == \
        _files(str(tmp_path / 'jax' / 'model-1'))
    if code == 14:
        # raw 16-bit words with an explicit code give the same bytes
        words = {k: v.view(np.uint16) for k, v in jax_side.items()}
        t_bundle.write_bundle(str(tmp_path / 'words' / 'model-1'), words,
                              dtype_codes={k: 14 for k in words})
        assert _files(str(tmp_path / 'words' / 'model-1')) == \
            _files(str(tmp_path / 'jax' / 'model-1'))


def _bits(x):
    """Any read tensor as comparable raw words."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == 'bfloat16' else x


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_package_reads_the_others_bundle(tmp_path, writer):
    prefix = str(tmp_path / 'model-7')
    written = {}
    for code in sorted(j_bundle._DTYPES):
        jax_side, port_side = _tensors(code)
        side = jax_side if writer == 'jax' else port_side
        written.update({'{}/{}'.format(code, k): v for k, v in side.items()})
    (j_bundle if writer == 'jax' else t_bundle).write_bundle(prefix, written)
    got_port = t_bundle.read_bundle(prefix)
    got_jax = j_bundle.read_bundle(prefix)
    assert set(got_port) == set(got_jax) == set(written)
    assert t_bundle.list_variables(prefix) == j_bundle.list_variables(prefix)
    for name, value in written.items():
        want = _bits(value)
        for got in (got_port[name], got_jax[name]):
            assert tuple(got.shape) == tuple(want.shape), name
            np.testing.assert_array_equal(_bits(got), want, err_msg=name)
        if name.startswith('14/'):
            assert got_port[name].dtype == torch.bfloat16


@pytest.mark.parametrize('crc', ['default', 'numpy'])
@pytest.mark.parametrize('target', ['data', 'index'])
def test_a_flipped_byte_raises(tmp_path, monkeypatch, crc, target):
    if crc == 'numpy':
        monkeypatch.setattr(tfrecord_io, 'crc32c_impl',
                            lambda: tfrecord_io.crc32c_numpy)
    prefix = str(tmp_path / 'model')
    t_bundle.write_bundle(prefix, {'w': np.arange(64, dtype=np.float32)})
    for module in (t_bundle, j_bundle):
        module.read_bundle(prefix)          # intact: reads
    path = prefix + ('.data-00000-of-00001' if target == 'data'
                     else '.index')
    raw = bytearray(open(path, 'rb').read())
    raw[10] ^= 0xFF
    open(path, 'wb').write(bytes(raw))
    for module in (t_bundle, j_bundle):
        with pytest.raises(ValueError, match='crc'):
            module.read_bundle(prefix)
    if target == 'data':
        # validation off reads the corrupt bytes without complaint
        t_bundle.read_bundle(prefix, validate=False)


CKPT = ['model/generator/enc0/conv2d/kernel',
        'model/generator/enc0/conv2d/bias',
        'model/generator/lstm1/gates/kernel',
        'train_op/beta1_power']
MATCH_CASES = {
    'suffixes': (['enc0/conv2d/kernel', 'lstm1/gates/kernel'], {}),
    'first_match_wins': (['kernel'], {}),
    'missing': (['enc9/conv2d/kernel'], {}),
    'missing_not_strict': (['enc9/missing'], dict(strict=False)),
    'rename': (['encoder_first/kernel'],
               dict(rename={'encoder_first/kernel': 'enc0/conv2d/kernel'})),
}


def _match(module, names, kw):
    try:
        return module.suffix_match(names, CKPT, **kw)
    except ValueError as e:
        return 'ValueError: {}'.format(e)


@pytest.mark.parametrize('case', sorted(MATCH_CASES))
def test_suffix_match_equals_jax(case):
    names, kw = MATCH_CASES[case]
    got = _match(t_import, names, kw)
    assert got == _match(j_import, names, kw)
    if case == 'missing':
        assert got.startswith('ValueError: did not find')


def test_import_shape_mismatch_raises(tmp_path):
    rng = np.random.RandomState(3)
    tree = {'params': {'enc0': {'kernel': rng.randn(3, 3, 2, 4).astype(
        np.float32), 'bias': np.zeros(4, np.float32)}}}
    prefix = str(tmp_path / 'model-1')
    t_import.export_tf1_checkpoint(tree, prefix)
    back, report = t_import.import_tf1_checkpoint(
        prefix, {'params': {'enc0': {k: np.zeros_like(v) for k, v in
                                     tree['params']['enc0'].items()}}})
    np.testing.assert_array_equal(back['params']['enc0']['kernel'],
                                  tree['params']['enc0']['kernel'])
    assert not report['missing'] and not report['unused_ckpt']
    bad = {'params': {'enc0': {'kernel': np.zeros((3, 3, 2, 5), np.float32),
                               'bias': np.zeros(4, np.float32)}}}
    for module in (t_import, j_import):
        with pytest.raises(ValueError, match='shape mismatch'):
            module.import_tf1_checkpoint(prefix, bad)


HP = {'designated_pixel_count': 1, 'run_batch_size': 4, 'sequence_length': 6,
      'context_frames': 2, 'ncam': 1, 'img_dims': (16, 16), 'adim': 3,
      'sdim': 3, 'num_masks': 4, 'dtype': 'float32', 'std_factor': 0}


def test_predictor_serves_a_jax_exported_bundle(tmp_path):
    """``TorchPredictor.restore`` serves the higher-step bundle that JAX
    exported, as ``TPUPredictor.restore`` does
    (``tests/test_tf1_import.py::test_predictor_restores_tf1_bundle``), and
    the two predict the same frames and distributions."""
    donor = TPUPredictor(str(tmp_path), HP).restore()     # seeded (warns)
    rng = np.random.RandomState(9)
    leaves, tree = jax.tree.flatten(donor.params[0])
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + rng.randn(*x.shape).astype(np.float32) * 0.1
        for x in leaves])
    view0 = tmp_path / 'view0'
    j_import.export_tf1_checkpoint(params, str(view0 / 'model-5000'))
    j_import.export_tf1_checkpoint(jax.tree.map(np.zeros_like, params),
                                   str(view0 / 'model-100'))   # stale

    served = TPUPredictor(str(tmp_path), HP).restore()
    ported = TorchPredictor(str(tmp_path), HP, device='cpu').restore()
    assert served.restored and ported.restored
    context = {
        'context_frames': rng.rand(2, 1, 16, 16, 3).astype(np.float32),
        'context_actions': (rng.randn(1, 3) * 0.1).astype(np.float32),
        'context_states': (rng.randn(2, 3) * 0.1).astype(np.float32),
        'context_pixel_distributions':
            rng.rand(2, 1, 16, 16, 1).astype(np.float32),
    }
    actions = {'actions': (rng.randn(3, 4, 3) * 0.1).astype(np.float32)}
    want, got = served(context, actions), ported(context, actions)
    for name in ('predicted_frames', 'predicted_pixel_distributions'):
        assert got[name].shape == want[name].shape == \
            ((3, 4, 1, 16, 16) + want[name].shape[-1:])
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   err_msg=name)


def test_predictor_raises_on_a_bad_bundle(tmp_path):
    """A bundle that does not load raises; the predictor never falls back
    to seeded weights where a bundle is present."""
    model = TorchPredictor(str(tmp_path), HP, device='cpu').model
    tree = params_to_flax(model.state_dict())
    prefix = str(tmp_path / 'view0' / 'model-10')
    t_import.export_tf1_checkpoint(tree, prefix)
    TorchPredictor(str(tmp_path), HP, device='cpu').restore()
    shard = prefix + '.data-00000-of-00001'
    raw = bytearray(open(shard, 'rb').read())
    raw[100] ^= 0x01
    open(shard, 'wb').write(bytes(raw))
    with pytest.raises(ValueError, match='crc'):
        TorchPredictor(str(tmp_path), HP, device='cpu').restore()
    os.remove(shard)
    with pytest.raises(FileNotFoundError):
        TorchPredictor(str(tmp_path), HP, device='cpu').restore()
    t_import.export_tf1_checkpoint(tree, prefix)
    with pytest.raises(ValueError, match='shape mismatch'):
        TorchPredictor(str(tmp_path), dict(HP, num_masks=5),
                       device='cpu').restore()


def test_flagship_round_trip(tmp_path):
    """The flagship's ``params.npz`` exported and imported: the same
    arrays; served from the bundle, the same state as from the file."""
    flat = read_npz(os.path.join(FLAGSHIP, 'view0', 'params.npz'))
    prefix = str(tmp_path / 'view0' / 'model-5000')
    t_import.export_tf1_checkpoint(unflatten_flax(flat), prefix)
    template = unflatten_flax({k: np.zeros_like(v) for k, v in flat.items()})
    back, report = t_import.import_tf1_checkpoint(prefix, template)
    assert len(report['matched']) == len(flat) == 38
    assert not report['missing'] and not report['unused_ckpt']
    back = t_import.leaf_paths(back)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype
        np.testing.assert_array_equal(back[key], value, err_msg=key)

    shutil.copy(os.path.join(FLAGSHIP, 'model_config.json'), tmp_path)
    with open(tmp_path / 'model_config.json') as f:
        assert json.load(f)['std_factor'] == 4
    from_bundle = TorchPredictor(str(tmp_path), {}, device='cpu').restore()
    from_file = TorchPredictor(FLAGSHIP, {}, device='cpu').restore()
    assert from_bundle.restored and from_file.restored
    want = from_file.models[0].state_dict()
    for key, value in from_bundle.models[0].state_dict().items():
        assert torch.equal(value, want[key]), key
