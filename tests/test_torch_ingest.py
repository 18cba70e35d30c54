"""Port parity: the native ingest engine and the fused loader,
``visual_foresight_torch.data.fused_ingest`` against the JAX package's.

- The port's own copy of ``native/ingest.cpp`` (built by
  ``ops/_build.py::build_host`` into ``build/native/``) against JAX's
  ``FusedTrajLoader`` on the same shards, one thread, shuffle off: raw
  frames round-trip exactly and equal JAX's batches bit for bit, with two
  cameras too; the JPEG path decodes to JAX's bytes; a shuffled two-epoch
  pass serves every trajectory twice; a dataset nothing of which decodes
  raises instead of blocking.  These skip only where ``g++``, ``jpeglib.h``
  or ``zlib.h`` is missing (``missing_build_tools``); with them present a
  failed build fails.
- The build follows the tools (``engine_build``): without ``jpeglib.h``
  the engine is built without JPEG decoding, reads raw shards as JAX's
  engine does and refuses JPEG shards, which ``make_loader`` then gives to
  the Python reader; without ``g++`` or ``zlib.h`` it is not built.  With
  libstdc++ linked into it statically it reads as JAX's engine does.
- ``make_loader``'s Python fallback serves JAX's fallback batches bit for
  bit, with the WARNING printed.
- ``device_ingest`` equals JAX's ``device_ingest`` in f32 and bf16.

Shards are tiny: 8 x 12 frames, T of 5, at most 8 trajectories.  Everything
is exact: no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from tests.test_torch_records import trajectory, write_shards
from visual_foresight_torch.agent.utils.traj_saver import GeneralAgentSaver
from visual_foresight_torch.data import fused_ingest as tingest
from visual_foresight_tpu.data import fused_ingest as jingest

T = 5


@pytest.fixture(scope='module')
def native():
    missing = tingest.missing_build_tools()
    if missing:
        pytest.skip('the native engine cannot be built here: no {}'.format(
            ', '.join(missing)))
    # the tools are present: a failed build is a failure, not a skip
    tingest._load_library()
    if not jingest.native_available():
        pytest.skip("the JAX package's engine did not build")


def _all_batches(package, directory, batch_size, **kw):
    loader = package.FusedTrajLoader(str(directory), batch_size=batch_size,
                                     **kw)
    try:
        return list(loader)
    finally:
        loader.close()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {'images', 'state', 'actions'}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize('ncam', [1, 2])
def test_raw_round_trip_equals_jax(tmp_path, native, ncam):
    trajs = write_shards(tmp_path, 'port', n_traj=8, T=T, ncam=ncam)
    kw = dict(num_epochs=1, shuffle=False, threads=1)
    got = _all_batches(tingest, tmp_path, 4, **kw)
    _assert_batches_equal(got, _all_batches(jingest, tmp_path, 4, **kw))
    assert got[0]['images'].shape == (4, T, ncam, 8, 12, 3)
    images = np.concatenate([b['images'] for b in got])
    state = np.concatenate([b['state'] for b in got])
    actions = np.concatenate([b['actions'] for b in got])
    for i, (_, obs, policy_out) in enumerate(trajs):
        np.testing.assert_array_equal(images[i], obs['images'])
        np.testing.assert_array_equal(state[i],
                                      obs['state'].astype(np.float32))
        np.testing.assert_array_equal(
            actions[i], np.stack([p['actions'] for p in policy_out]))


def test_jpeg_path_equals_jax(tmp_path, native):
    pytest.importorskip('cv2', reason='the shards are JPEG-coded by OpenCV')
    saver = GeneralAgentSaver(str(tmp_path), T, traj_per_file=4,
                              split=(1.0, 0.0, 0.0), image_coding='jpeg')
    for i in range(4):
        agent_data, obs, policy_out = trajectory(i, T)
        saver.save_traj(agent_data, obs, policy_out)
    saver.flush()
    kw = dict(num_epochs=1, shuffle=False, threads=1)
    got = _all_batches(tingest, tmp_path, 4, **kw)
    _assert_batches_equal(got, _all_batches(jingest, tmp_path, 4, **kw))
    loader = tingest.FusedTrajLoader(str(tmp_path), 4, num_epochs=1,
                                     threads=1)
    assert loader.sequence_length == T
    loader.close()


def test_shuffled_epochs_cover_every_trajectory(tmp_path, native):
    trajs = write_shards(tmp_path, 'port', n_traj=8, T=T)
    first_frames = {trajectory(i, T)[1]['images'][0].tobytes(): i
                    for i in range(len(trajs))}
    seen = []
    for batch in _all_batches(tingest, tmp_path, 2, num_epochs=2,
                              shuffle=True, threads=2, pool_size=4):
        assert batch['images'].shape == (2, T, 1, 8, 12, 3)
        seen += [first_frames[b[0].tobytes()] for b in batch['images']]
    assert sorted(seen) == sorted(list(range(8)) * 2)


def test_engine_raises_when_nothing_decodes(tmp_path, native):
    write_shards(tmp_path, 'port', n_traj=4, T=T)
    # a resolution the raw frames do not have: every trajectory is
    # rejected, and the engine must report it rather than block
    with pytest.raises((RuntimeError, StopIteration)):
        loader = tingest.FusedTrajLoader(str(tmp_path), batch_size=2,
                                         threads=1, image_hw=(4, 6))
        try:
            next(loader)
        finally:
            loader.close()


def test_make_loader_python_fallback_equals_jax(tmp_path, capsys):
    write_shards(tmp_path, 'port', n_traj=8, T=T, traj_per_file=3)
    got, want = [], []
    for package, out in ((tingest, got), (jingest, want)):
        it = package.make_loader(str(tmp_path), 3, prefer_native=False,
                                 threads=2, seed=0)
        out += [next(it) for _ in range(4)]
    assert 'WARNING: native ingest unavailable' in capsys.readouterr().out
    _assert_batches_equal(got, want)
    assert got[0]['images'].dtype == np.uint8
    with pytest.raises(NotImplementedError, match='native'):
        tingest.make_loader(str(tmp_path), 3, prefer_native=False,
                            image_hw=(4, 6))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_device_ingest_equals_jax(dtype):
    u8 = np.random.RandomState(0).randint(0, 256, (2, 3, 8, 12, 3),
                                          dtype=np.uint8)
    u8[0, 0, 0, :2, 0] = (0, 255)
    got = tingest.device_ingest(u8, getattr(torch, dtype))
    want = np.asarray(jingest.device_ingest(jnp.asarray(u8),
                                            getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.device.type == 'cpu'
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    # a tensor input stays a tensor of the same values
    again = tingest.device_ingest(torch.from_numpy(u8), getattr(torch, dtype))
    assert torch.equal(again, got)


@pytest.mark.parametrize('missing', [[], ['jpeglib.h'], ['zlib.h'], ['g++']])
def test_engine_build_follows_the_tools(monkeypatch, missing):
    monkeypatch.setattr(tingest, 'missing_build_tools', lambda: missing)
    if 'zlib.h' in missing or 'g++' in missing:
        with pytest.raises(RuntimeError, match=missing[0]):
            tingest.engine_build()
    else:
        flags, libs = tingest.engine_build()
        assert ('-DVFI_NO_JPEG' in flags) == bool(missing)
        assert ('-ljpeg' in libs) != bool(missing) and '-lz' in libs


def test_engine_without_libjpeg_reads_raw_and_refuses_jpeg(tmp_path, native,
                                                           monkeypatch,
                                                           capsys):
    """The build for a machine without ``jpeglib.h``: raw shards as JAX's
    engine reads them; JPEG shards refused, and ``make_loader`` falls back
    to the Python reader."""
    monkeypatch.setattr(tingest, 'missing_build_tools',
                        lambda: ['jpeglib.h'])
    monkeypatch.setattr(tingest, '_lib', None)
    monkeypatch.setattr(tingest, '_decodes_jpeg', None)
    write_shards(tmp_path / 'raw', 'port', n_traj=4, T=T)
    kw = dict(num_epochs=1, shuffle=False, threads=1)
    _assert_batches_equal(_all_batches(tingest, tmp_path / 'raw', 4, **kw),
                          _all_batches(jingest, tmp_path / 'raw', 4, **kw))
    assert tingest._decodes_jpeg is False
    assert tingest.native_available() and \
        not tingest.native_available(jpeg=True)
    pytest.importorskip('cv2', reason='the shards are JPEG-coded by OpenCV')
    saver = GeneralAgentSaver(str(tmp_path / 'jpeg'), T, traj_per_file=4,
                              split=(1.0, 0.0, 0.0), image_coding='jpeg')
    for i in range(4):
        saver.save_traj(*trajectory(i, T))
    saver.flush()
    with pytest.raises(RuntimeError, match='libjpeg'):
        tingest.FusedTrajLoader(str(tmp_path / 'jpeg'), 4, threads=1)
    capsys.readouterr()
    batch = next(tingest.make_loader(str(tmp_path / 'jpeg'), 4,
                                     shuffle=False))
    assert 'WARNING: native ingest unavailable' in capsys.readouterr().out
    assert batch['images'].shape == (4, T, 1, 8, 12, 3)


def test_engine_with_libstdcxx_linked_statically_equals_jax(tmp_path, native,
                                                            monkeypatch):
    """Some compilers link libstdc++ into the library statically; the
    engine must read its config and its shards the same then."""
    flags, libs = tingest.engine_build()
    monkeypatch.setattr(tingest, 'engine_build', lambda: (
        flags + ('-static-libstdc++', '-static-libgcc'), libs))
    monkeypatch.setattr(tingest, '_lib', None)
    monkeypatch.setattr(tingest, '_decodes_jpeg', None)
    write_shards(tmp_path, 'port', n_traj=8, T=T, ncam=2)
    kw = dict(num_epochs=1, shuffle=False, threads=1)
    _assert_batches_equal(_all_batches(tingest, tmp_path, 4, **kw),
                          _all_batches(jingest, tmp_path, 4, **kw))
