"""The port reads and writes the JAX package's orbax checkpoints with numpy
alone: ``utils/zstd.py`` (its own decoder, ``native/zstd_decode.cpp``),
``utils/ocdbt.py``, ``utils/zarr.py`` and ``prediction/checkpoints.py``.

- The decoder against ``zstandard`` at levels 1, 3, 19 and 22, with and
  without content checksums, on random bytes, f32 weights and long runs; on
  streamed, concatenated and skippable frames; on every zstd frame of both
  vendored step directories.  A dictionary, a bad checksum, a bad magic and
  truncated input raise ValueError; a missing ``g++`` raises and names it.
- The OCDBT reader lists the keys and values ``tensorstore`` lists, on both
  vendored step directories and on stores ``tensorstore`` writes with
  interior b-tree nodes, version-tree nodes, inline versions and no
  compression; ``tensorstore`` reads what ``write_store`` writes; a flipped
  byte fails the CRC32C.
- Both vendored restores equal JAX's ``checkpoints.restore_params`` and the
  numpy exports bit for bit, and ``TorchPredictor`` serves them
  (``restored`` True); a step directory that does not read raises.
- A step directory the port writes (f32, bf16, int32 scalars, an optax
  chain state) restores through JAX's ``restore_params`` bit for bit, and
  the port reads JAX's; ``suffix_match_restore``, ``latest_checkpoint`` and
  ``resolve_model_dir`` give JAX's answers.
- The four scoring nets restore from JAX-saved step directories, and the
  port's ``save_network`` writes one JAX reads.
- Cross-package resume of a tiny trainer run: the port resumes JAX's run
  after 2 steps and JAX resumes the port's, each taking a third step that
  is held against the other package's: losses rtol 5e-5, parameters 5e-3
  of each leaf's change in the step (the train goldens' tolerances).
"""

import glob
import os
import shutil
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import zstandard

from test_torch_planner import few_torch_threads  # noqa: F401
from tests import test_torch_train as TT
from visual_foresight_torch.models import classifier as tclf
from visual_foresight_torch.models import gdn as tgdn
from visual_foresight_torch.models import inverse as tinv
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_from_flax,
                                                   params_to_flax, read_npz,
                                                   restore_network)
from visual_foresight_torch.ops import _build
from visual_foresight_torch.prediction import checkpoints as P
from visual_foresight_torch.prediction.predictor import TorchPredictor
from visual_foresight_torch.training import net_trainer
from visual_foresight_torch.training import train_predictor as ttrain
from visual_foresight_torch.utils import ocdbt, zstd
from visual_foresight_tpu.models import classifier as jclf
from visual_foresight_tpu.models import gdn as jgdn
from visual_foresight_tpu.models import inverse as jinv
from visual_foresight_tpu.prediction import checkpoints as J
from visual_foresight_tpu.training import train_predictor as jtrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENDORED = ('xz_flagship', 'ag_r5f_v2')
LOSS_RTOL = 5e-5          # the train goldens' tolerances
CHANGE_TOL = 5e-3


def _step_dir(name):
    return glob.glob(os.path.join(REPO, 'benchmarks', 'models', name,
                                  'view0', 'step_*'))[0]


def _same(a, b, path='tree'):
    """Trees equal bit for bit: the same structure, shapes, dtypes and
    bytes (a bfloat16 leaf as its 16-bit words on either side)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, b)
        for k in a:
            _same(a[k], b[k], '{}/{}'.format(path, k))
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, '{}/{}'.format(path, i))
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    words = []
    for x in (a, b):
        if isinstance(x, torch.Tensor):
            x = x.numpy() if x.dtype != torch.bfloat16 else \
                x.view(torch.int16).numpy().view('bfloat16')
        x = np.asarray(x)
        words.append((x.shape, x.dtype.name, x.tobytes()))
    assert words[0] == words[1], (path, words[0][:2], words[1][:2])


# -- the decoder ---------------------------------------------------------------

def _payloads():
    rng = np.random.RandomState(0)
    return {
        'random': rng.bytes(150000),
        'f32': (rng.randn(60000) * 0.05).astype(np.float32).tobytes(),
        'runs': b'a' * 150000 + bytes(range(256)) * 200 + b'\0' * 70000 +
        b'xy' * 9000,
    }


@pytest.mark.parametrize('checksum', [False, True])
@pytest.mark.parametrize('level', [1, 3, 19, 22])
def test_decoder_matches_zstandard(level, checksum):
    for name, data in _payloads().items():
        frame = zstandard.ZstdCompressor(level=level,
                                         write_checksum=checksum).compress(
            data)
        assert zstd.decompress(frame) == data, name


def test_decoder_reads_streamed_concatenated_and_skippable_frames():
    data = _payloads()
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = obj.compress(data['f32']) + obj.flush()   # no content size
    skippable = struct.pack('<II', 0x184D2A5F, 5) + b'12345'
    small = zstandard.ZstdCompressor(level=19, write_checksum=True) \
        .compress(b'two' * 999)
    empty = zstandard.ZstdCompressor().compress(b'')
    assert zstd.decompress(streamed + skippable + small + empty) == \
        data['f32'] + b'two' * 999
    # a last block that ends at the window's edge: 2 windows of 128 KiB
    edge = (np.random.RandomState(1).randn(65536) * 0.1).astype(
        np.float32).tobytes()
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=17)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(edge)
    assert zstd.decompress(frame) == edge


def _frames_of(step_dir):
    """Every zstd frame of a step directory: the manifests' and nodes'
    bodies and every zarr chunk."""
    frames = []
    for path in glob.glob(os.path.join(step_dir, '**', 'manifest.ocdbt'),
                          recursive=True):
        with open(path, 'rb') as f:
            frames.append(f.read()[14:-4])
    reader = ocdbt.OcdbtReader(step_dir)
    for key in reader.keys():
        if not key.endswith('.zarray'):
            frames.append(reader.read(key))
    for path in glob.glob(os.path.join(step_dir, 'd', '*')):
        with open(path, 'rb') as f:
            frames.append(f.read()[14:-4])
    return frames


@pytest.mark.parametrize('name', VENDORED)
def test_decoder_reads_every_frame_of_the_vendored_checkpoint(name):
    frames = _frames_of(_step_dir(name))
    assert len(frames) == 38 + 3
    dctx = zstandard.ZstdDecompressor()
    for frame in frames:
        assert frame[:4] == zstd.FRAME_MAGIC
        want = dctx.decompressobj().decompress(frame)
        assert zstd.decompress(frame) == want


def test_decoder_refuses_a_dictionary_and_malformed_input():
    samples = [bytes(np.random.RandomState(i).randint(0, 4, 300).astype(
        np.uint8)) + b'common words %d' % i for i in range(200)]
    trained = zstandard.train_dictionary(2048, samples)
    assert trained.dict_id()
    framed = zstandard.ZstdCompressor(dict_data=trained).compress(samples[0])
    with pytest.raises(ValueError, match='dictionary'):
        zstd.decompress(framed)
    good = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(_payloads()['f32']))
    bad = bytearray(good)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match='checksum'):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match='magic'):
        zstd.decompress(b'\0' + bytes(good[1:]))
    for cut in (0, 3, 5, 9, len(good) // 2, len(good) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(bytes(good[:cut]))


def test_a_missing_compiler_raises_and_names_it(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'HOST_BUILD_DIR', tmp_path / 'native')
    monkeypatch.setenv('CXX', 'no-such-compiler-vf')
    monkeypatch.setattr(zstd, '_lib', None)
    with pytest.raises(RuntimeError, match=r'g\+\+'):
        P.restore_params(os.path.dirname(_step_dir('xz_flagship')))


# -- the OCDBT store -----------------------------------------------------------

def _tensorstore_store(root, config=None):
    """``tensorstore``'s OCDBT store at ``root`` (with ``config``)."""
    import tensorstore as ts
    spec = ts.KvStore.Spec('file://{}/|ocdbt:'.format(
        os.path.abspath(root))).to_json()
    if config is not None:
        spec['config'] = config
    return ts.KvStore.open(spec).result()


def _tensorstore_items(root):
    kv = _tensorstore_store(root)
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


# (config, versions, keys): interior nodes, version-tree nodes, no
# compression, inline versions only
TS_STORES = {
    'interior_nodes': ({'max_decoded_node_bytes': 600}, 1, 120),
    'version_tree': ({'version_tree_arity_log2': 2}, 9, 3),
    'uncompressed': ({'compression': None}, 2, 5),
    'inline': ({'max_inline_value_bytes': 10}, 1, 4),
}


@pytest.mark.parametrize('case', list(TS_STORES) + list(VENDORED))
def test_ocdbt_reader_lists_what_tensorstore_lists(case, tmp_path):
    if case in VENDORED:
        root = _step_dir(case)
    else:
        config, versions, n = TS_STORES[case]
        root = str(tmp_path / case)
        kv = _tensorstore_store(root, config)
        for v in range(versions):
            for k in range(n):
                kv.write('key/{:04d}/{}'.format(k, v),
                         b'x' * (k * 37 % 2000) + bytes([k % 256])).result()
    reader = ocdbt.OcdbtReader(root)
    want = _tensorstore_items(root)
    assert reader.keys() == sorted(want)
    assert reader.items() == want
    if case in VENDORED:
        assert len(want) == 76
    else:
        gens = [v['generation'] for v in reader.versions()]
        assert gens == sorted(gens) and len(gens) >= versions * n


def test_tensorstore_reads_what_the_port_writes(tmp_path):
    items = {'a/.zarray': b'{}', 'a/0': bytes(range(256)) * 20, 'b': b'',
             'ab': b'inline', 'a/0.1': b'y' * 1025}
    ocdbt.write_store(str(tmp_path), items)
    assert _tensorstore_items(str(tmp_path)) == items
    assert ocdbt.OcdbtReader(str(tmp_path)).items() == items


def test_a_corrupt_crc_raises(tmp_path):
    root = str(tmp_path / 'step')
    shutil.copytree(_step_dir('xz_flagship'), root)
    manifest = os.path.join(root, 'manifest.ocdbt')
    with open(manifest, 'rb') as f:
        good = f.read()
    with open(manifest, 'wb') as f:
        f.write(good[:-6] + bytes([good[-6] ^ 0x40]) + good[-5:])
    with pytest.raises(ValueError, match='CRC32C'):
        ocdbt.OcdbtReader(root)
    with open(manifest, 'wb') as f:
        f.write(good)
    node = glob.glob(os.path.join(root, 'd', '*'))[0]
    with open(node, 'r+b') as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(ValueError, match='CRC32C'):
        ocdbt.OcdbtReader(root).keys()
    # a step directory that does not read raises: no seeded weights
    model = str(tmp_path / 'model')
    os.makedirs(os.path.join(model, 'view0'))
    shutil.copy(os.path.join(REPO, 'benchmarks', 'models', 'xz_flagship',
                             'model_config.json'), model)
    shutil.move(root, os.path.join(model, 'view0', 'step_5000'))
    with pytest.raises(ValueError, match='CRC32C'):
        TorchPredictor(model, {'dtype': 'float32'}, device='cpu').restore()


# -- restores ----------------------------------------------------------------

@pytest.mark.parametrize('name', VENDORED)
def test_vendored_restore_equals_jax_and_the_numpy_export(name):
    view = os.path.join(REPO, 'benchmarks', 'models', name, 'view0')
    tree = P.restore_params(view)
    _same(jax.device_get(J.restore_params(view)), tree)
    export = read_npz(os.path.join(REPO, 'visual_foresight_torch', 'weights',
                                   name, 'view0', 'params.npz'))
    assert flatten_flax(tree) .keys() == export.keys()
    _same(export, flatten_flax(tree))


@pytest.mark.parametrize('name', VENDORED)
def test_predictor_restores_the_vendored_orbax_checkpoint(name):
    served = TorchPredictor(os.path.join(REPO, 'benchmarks', 'models', name),
                            {'dtype': 'float32'}, device='cpu').restore()
    assert served.restored is True
    export = TorchPredictor(os.path.join(REPO, 'visual_foresight_torch',
                                         'weights', name),
                            {'dtype': 'float32'}, device='cpu').restore()
    got, want = served.models[0].state_dict(), export.models[0].state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _optax_state():
    """A JAX ``chain(clip_by_global_norm, adamw(schedule))`` state after
    one update, as numpy."""
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10),
        weight_decay=1e-5))
    params = {'params': {'conv': {'kernel': jnp.ones((3, 3, 2, 4)),
                                  'bias': jnp.zeros(4)}}}
    state = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    _, state = tx.update(grads, state, params)
    return tx, params, jax.device_get(state)


def _trees():
    rng = np.random.RandomState(3)
    return {
        'f32': {'params': {'w': rng.randn(3, 4).astype(np.float32),
                           'b': np.float32(rng.randn(7))}},
        'bf16': {'params': {'w': torch.randn(4, 5, generator=torch.Generator(
            ).manual_seed(0)).to(torch.bfloat16)}},
        'scalars': {'count': np.int32(7), 'step': np.asarray(3, np.int32),
                    'mix': [np.int64(2), np.uint32(5), np.float64(2.5),
                            np.array([True, False])]},
    }


@pytest.mark.parametrize('case', ['f32', 'bf16', 'scalars', 'optax'])
def test_jax_restores_what_the_port_writes(case, tmp_path):
    if case == 'optax':
        tx, params, tree = _optax_state()
        port_tree = P.restore_params(J.save_params(tree, str(tmp_path / 'j'),
                                                   1).rsplit('/', 1)[0])
        _same(jax.tree_util.tree_leaves(tree),
              [x for x in jax.tree_util.tree_leaves(port_tree)])
        P.save_params(port_tree, str(tmp_path / 'p'), 1)
        back = J.restore_params(str(tmp_path / 'p'),
                                template=tx.init(params))
        _same(jax.tree_util.tree_leaves(jax.device_get(back)),
              jax.tree_util.tree_leaves(tree))
        assert type(back[1][0]).__name__ == 'ScaleByAdamState'
        return
    tree = _trees()[case]
    path = P.save_params(tree, str(tmp_path), 4)
    assert path.endswith('step_4')
    _same(tree, jax.device_get(J.restore_params(str(tmp_path))))
    _same(tree, P.restore_params(str(tmp_path)))


def test_the_port_reads_what_jax_writes(tmp_path):
    tree = {'params': {'w': jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
                       'v': np.arange(6, dtype=np.float32)},
            'count': np.int32(3), 'seq': (np.float32(1.5), None)}
    J.save_params(jax.device_get(tree), str(tmp_path), 9)
    got = P.restore_params(str(tmp_path), step=9)
    assert got['seq'][1] is None
    assert got['params']['w'].dtype == torch.bfloat16
    _same(jax.device_get(tree), got)
    _, _, state = _optax_state()
    J.save_params(state, str(tmp_path / 'opt'), 2)
    _same(jax.tree_util.tree_leaves(state),
          jax.tree_util.tree_leaves(P.restore_params(str(tmp_path / 'opt'))))


def test_restore_checks_the_template_and_missing_steps(tmp_path):
    tree = _trees()['f32']
    P.save_params(tree, str(tmp_path), 1)
    P.restore_params(str(tmp_path), template=tree)
    wrong = {'params': {'w': np.zeros((4, 3), np.float32), 'b': tree[
        'params']['b']}}
    with pytest.raises(ValueError, match='template'):
        P.restore_params(str(tmp_path), template=wrong)
    with pytest.raises(ValueError, match='float64'):
        P.restore_params(str(tmp_path), template={'params': {
            'w': tree['params']['w'].astype(np.float64),
            'b': tree['params']['b']}})
    for missing in (str(tmp_path / 'none'), str(tmp_path / 'empty')):
        os.makedirs(str(tmp_path / 'empty'), exist_ok=True)
        with pytest.raises(FileNotFoundError):
            P.restore_params(missing)
        with pytest.raises(FileNotFoundError):
            J.restore_params(missing)
    with pytest.raises(FileNotFoundError):
        P.restore_params(str(tmp_path), step=2)


def test_suffix_match_restore_matches_jax():
    rng = np.random.RandomState(5)
    # a source path that is a suffix of the target's matches; a shape that
    # differs or a prefix that is not the target's does not
    source = {'enc0': {'kernel': rng.randn(3, 3, 2, 4), 'bias': rng.randn(4)},
              'head': {'kernel': rng.randn(4, 2)},
              'old': {'new': {'0': rng.randn(2)}}}
    target = {'params': {'enc0': {'kernel': np.zeros((3, 3, 2, 4)),
                                  'bias': np.zeros(4)},
                         'head': {'kernel': np.zeros((4, 3))},
                         'new': [np.zeros(2), np.ones(2)]}}
    want = jax.device_get(J.suffix_match_restore(source, target))
    got = P.suffix_match_restore(source, target)
    _same(want, got)
    assert got['params']['enc0']['bias'] is source['enc0']['bias']
    assert got['params']['head']['kernel'] is target['params']['head'][
        'kernel']


def test_latest_checkpoint_and_resolve_model_dir_match_jax(tmp_path):
    root = str(tmp_path)
    layouts = {'empty': [], 'steps': ['view0/step_3', 'view0/step_12',
                                      'view0/step_x'],
               'tf1': ['view0/model-100.index'], 'other_view': ['view1/'
                                                               'step_1'],
               'stale': ['view0/params.npz']}
    for name, files in layouts.items():
        os.makedirs(os.path.join(root, name, 'view0'), exist_ok=True)
        for f in files:
            path = os.path.join(root, name, f)
            if '.' in os.path.basename(f):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                open(path, 'w').close()
            else:
                os.makedirs(path, exist_ok=True)
    for name in list(layouts) + ['missing']:
        view = os.path.join(root, name, 'view0')
        assert P.latest_checkpoint(view) == J.latest_checkpoint(view), name
    cands = [os.path.join(root, n) for n in ('missing', 'stale', 'empty',
                                             'tf1', 'steps')]
    for i in range(len(cands)):
        for view in ('view0', 'view1'):
            assert P.resolve_model_dir(cands[i:], view) == \
                J.resolve_model_dir(cands[i:], view)
    assert P.resolve_model_dir(cands) == cands[3]


# -- the scoring nets ----------------------------------------------------------

@pytest.mark.parametrize('name', ['gdn', 'classifier', 'nce', 'inverse'])
def test_scoring_nets_restore_from_a_jax_step_directory(name, tmp_path):
    frame = jnp.asarray(np.random.RandomState(15).rand(1, 16, 24, 3).astype(
        np.float32))
    jnet, args, tnet = {
        'gdn': (jgdn.GoalDistanceNet(), (frame, frame),
                tgdn.GoalDistanceNet),
        'classifier': (jclf.SuccessClassifier(), (frame, frame),
                       tclf.SuccessClassifier),
        'nce': (jclf.NCEEmbedding(), (frame,), tclf.NCEEmbedding),
        'inverse': (jinv.InverseNet(3, 7), (frame, frame, jnp.stack(
            [frame, frame], 1)), lambda: tinv.InverseNet(3, 7, 2)),
    }[name]
    params = jax.device_get(jnet.init(jax.random.PRNGKey(4), *args))
    J.save_params(params, str(tmp_path), 100)
    net = tnet()
    assert restore_network(net, str(tmp_path)) is True
    got = net.state_dict()
    want = params_from_flax(params)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key]), key
    # the port's trainers write the step directory JAX reads
    out = str(tmp_path / 'port')
    net_trainer.save_network(net, out, {'name': name}, 7)
    _same(params, jax.device_get(J.restore_params(out)))


# -- cross-package resume ------------------------------------------------------

_JAX = {}


def _jax_trainer(case):
    """JAX's loss and optax chain of ``test_torch_train``'s ``case`` (one
    compile a case) and its initial parameters."""
    if case in _JAX:
        return _JAX[case]
    opts, stochastic, _ = TT.CASES[case]
    jm = TT.JaxPredictor(**TT._model_kw(opts))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, TT.H, TT.W, 3)),
                     jnp.zeros((1, TT.SEQ - 1, 3)), jnp.zeros((1, 2, 3)))
    jpost = None
    loss_kw = dict(ss_k=TT.SS_K, **(TT.KL if stochastic else {}))
    if stochastic:
        jpost = TT.JaxPosterior(latent_dim=opts['latent_dim'],
                                features=TT.FEATURES)
        params = {'model': params, 'posterior': jpost.init(
            jax.random.PRNGKey(1), jnp.zeros((1, TT.SEQ, TT.H, TT.W, 3)))}
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, TT.LR, warmup_steps=min(200, TT.STEPS // 10 + 1),
        decay_steps=max(TT.STEPS, 2))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=1e-5))
    loss_fn = jtrain.make_loss_fn(jm, 2, posterior=jpost, **loss_kw)

    @jax.jit
    def step(params, opt_state, batch, rng, step):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, rng, step)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, metrics

    _JAX[case] = (step, tx, params, loss_kw)
    return _JAX[case]


def _port_trainer(case, init=None):
    """The port's modules, optimizer and train step of ``case``, with
    ``init`` (JAX's initial tree) loaded where given."""
    opts, stochastic, _ = TT.CASES[case]
    tm = CDNAPredictor((TT.H, TT.W), **TT._model_kw(opts))
    tpost = ttrain.PosteriorEncoder(opts['latent_dim'], TT.FEATURES) \
        if stochastic else None
    if init is not None:
        init = jax.tree.map(np.asarray, init)
        load_flax_params(tm, init['model'] if stochastic else init)
        if stochastic:
            load_flax_params(tpost, init['posterior'])
    ttx = ttrain.ClippedAdamW(ttrain._named_params(tm, tpost),
                              ttrain.training_schedule(
                                  TT._args(steps=TT.STEPS)))
    _, _, _, loss_kw = _jax_trainer(case)
    return tm, tpost, ttx, ttrain.make_train_step(tm, ttx, 2, posterior=tpost,
                                                  **loss_kw)


def _port_step(tstep, batch, step, case):
    mask, eps = TT._draws(jax.random.PRNGKey(100 + step), step,
                          TT.CASES[case][0].get('latent_dim', 0))
    return tstep({k: torch.tensor(v) for k, v in batch.items()}, step,
                 gt_mask=torch.tensor(mask),
                 eps=None if eps is None else torch.tensor(eps))


def _flat(tm, tpost):
    """The port's parameters as flat flax keys, copied (the arrays of
    ``params_to_flax`` may share the parameters' memory)."""
    out = flatten_flax(params_to_flax(tm.state_dict()))
    if tpost is not None:
        out.update({'posterior/' + k: v for k, v in flatten_flax(
            params_to_flax(tpost.state_dict())).items()})
    return {k: v.copy() for k, v in out.items()}


def _jax_flat(params, stochastic):
    params = jax.tree.map(np.asarray, params)
    if not stochastic:
        return flatten_flax(params)
    out = flatten_flax(params['model'])
    out.update({'posterior/' + k: v for k, v in
                flatten_flax(params['posterior']).items()})
    return out


def _hold(got, want, before):
    assert got.keys() == want.keys()
    for leaf, w in want.items():
        change = float(np.abs(w - before[leaf]).max())
        err = float(np.abs(got[leaf] - w).max())
        assert err <= CHANGE_TOL * change, (leaf, err, change)


@pytest.mark.parametrize('case', ['classic', 'std-stochastic'])
def test_the_port_resumes_a_jax_run(case, tmp_path):
    step_fn, tx, params, _ = _jax_trainer(case)
    stochastic = TT.CASES[case][1]
    batch = TT._batch(TT.CASES[case][2])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt_state = tx.init(params)
    for step in range(2):
        params, opt_state, _ = step_fn(params, opt_state, jb,
                                       jax.random.PRNGKey(100 + step),
                                       jnp.asarray(float(step)))
    jtrain._save_all(types.SimpleNamespace(model_dir=str(tmp_path),
                                           stochastic=stochastic),
                     params, opt_state, 2)
    after, _, jmet = step_fn(params, opt_state, jb, jax.random.PRNGKey(102),
                             jnp.asarray(2.0))

    tm, tpost, ttx, tstep = _port_trainer(case)
    assert ttrain._restore(types.SimpleNamespace(model_dir=str(tmp_path)),
                           tm, tpost, ttx) == 2
    before = _jax_flat(params, stochastic)
    _same(before, _flat(tm, tpost))
    assert ttx.count == 2
    adam = jax.device_get(opt_state)[1][0]
    for moment in ('mu', 'nu'):
        want = getattr(adam, moment)
        trees = {'model': want['model'], 'posterior': want['posterior']} \
            if stochastic else {'model': want}
        for key, tree in trees.items():
            for n, v in params_from_flax(tree).items():
                assert np.array_equal(
                    ttx.state()[moment]['{}/{}'.format(key, n)].numpy(), v)
    tmet = _port_step(tstep, batch, 2, case)
    np.testing.assert_allclose(float(tmet['loss']), float(jmet['loss']),
                               rtol=LOSS_RTOL)
    _hold(_flat(tm, tpost), _jax_flat(after, stochastic), before)


@pytest.mark.parametrize('case', ['classic', 'std-stochastic'])
def test_jax_resumes_a_port_run(case, tmp_path):
    step_fn, tx, params0, _ = _jax_trainer(case)
    stochastic = TT.CASES[case][1]
    batch = TT._batch(TT.CASES[case][2])
    tm, tpost, ttx, tstep = _port_trainer(case, init=params0)
    for step in range(2):
        _port_step(tstep, batch, step, case)
    ttrain.save_all(str(tmp_path), tm, tpost, ttx, 2)
    before = _flat(tm, tpost)
    tmet = _port_step(tstep, batch, 2, case)

    # JAX's resume (visual_foresight_tpu/training/train_predictor.py)
    view = os.path.join(str(tmp_path), 'view0')
    start = int(J.latest_checkpoint(view).rsplit('_', 1)[1])
    assert start == 2
    if stochastic:
        params = {'model': J.restore_params(view, template=params0['model'],
                                            step=start),
                  'posterior': J.restore_params(
                      os.path.join(str(tmp_path), 'posterior'),
                      template=params0['posterior'], step=start)}
    else:
        params = J.restore_params(view, template=params0)
    opt_state = J.restore_params(os.path.join(str(tmp_path), 'opt'),
                                 template=tx.init(params0), step=start)
    assert int(opt_state[1][0].count) == int(opt_state[1][2].count) == 2
    _same(_jax_flat(params, stochastic), before)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    after, _, jmet = step_fn(params, opt_state, jb, jax.random.PRNGKey(102),
                             jnp.asarray(2.0))
    np.testing.assert_allclose(float(jmet['loss']), float(tmet['loss']),
                               rtol=LOSS_RTOL)
    _hold(_jax_flat(after, stochastic), _flat(tm, tpost), before)


def test_the_port_still_resumes_its_numpy_files(tmp_path, capsys):
    """A run directory without step directories (written before the port
    wrote them) resumes from ``view0/params.npz`` and ``opt_state.npz``."""
    tm, tpost, ttx, tstep = _port_trainer('classic')
    batch = TT._batch(False)
    for step in range(2):
        _port_step(tstep, batch, step, 'classic')
    ttrain.save_all(str(tmp_path), tm, tpost, ttx, 2)
    for sub in ('view0', 'opt'):
        shutil.rmtree(os.path.join(str(tmp_path), sub, 'step_2'))
    other, _, otx, _ = _port_trainer('classic')
    assert ttrain._restore(types.SimpleNamespace(model_dir=str(tmp_path)),
                           other, None, otx) == 2
    assert 'resumed opt state at step 2' in capsys.readouterr().out
    _same(_flat(tm, None), _flat(other, None))
    assert otx.count == 2
