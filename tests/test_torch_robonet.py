"""Port parity: the RoboNet HDF5 reader (``data/robonet_reader.py``) and
the predictor trainer's ``--data_dir`` on HDF5 trajectories, against the
JAX package.

- ``RoboNetTrajReader`` of both packages, with the same seed on the same
  files, gives the same batches bit for bit (shuffled, over two epochs):
  traj-per-file with per-step JPEG frames, the same read with
  ``channel_order='legacy_bgr'``, traj-per-file with mp4 frames, and the
  bucketed layout that the port's ``HDF5Saver`` writes.  The files are
  written by the port's ``utils/file_2_hdf5.save_hdf5`` and
  ``agent/utils/hdf5_saver.py``.  Neither machine here encodes mp4 (no
  ``imageio-ffmpeg``): the mp4 case stores each camera's frames as an
  ``.npy`` payload in the ``frames`` dataset and hands both readers the same
  decoder through ``imageio.mimread``, so the layout is what is held, not
  the codec.
- ``discover``'s layouts and its ``FileNotFoundError``; the trajectories
  shorter than ``sequence_length``, skipped and counted alike.
- Errors reach the caller: a missing ``h5py`` names it when the reader is
  built, and a file that does not decode raises at the next batch (the
  JAX reader's thread ends the stream instead).
- ``train_predictor.record_batches`` on an HDF5 directory gives JAX's
  batches bit for bit, and three Adam steps of the classic backbone from
  JAX's initial weights on them, JAX's draws injected, give JAX's losses
  within rtol 1e-4.
- ``chip_smoke.train_from_hdf5`` (the card script's HDF5 phase, which the
  card machine skips while it lacks ``h5py``) writes its trajectories by
  ``HDF5Saver`` and trains from them on the CPU at tiny widths, logging
  finite values every step; it fails on a value that is not finite.
"""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from tests.test_torch_train import SS_K, _draws, _model_kw
from visual_foresight_torch.agent.utils.hdf5_saver import HDF5Saver
from visual_foresight_torch.data import robonet_reader as t_reader
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import load_flax_params
from visual_foresight_torch.training import train_predictor as ttrain
from visual_foresight_torch.utils import file_2_hdf5 as t_f2h
from visual_foresight_tpu.data import robonet_reader as j_reader
from visual_foresight_tpu.models.cdna import CDNAPredictor as JaxPredictor
from visual_foresight_tpu.training import train_predictor as jtrain

T, NCAM, H, W = 6, 2, 16, 16
META = {'camera_configuration': 'multiview', 'policy_desc': 'random',
        'bin_type': 'none', 'bin_insert': 'none',
        'contains_annotation': False, 'robot': 'sim', 'gripper': 'none',
        'background': 'sim', 'action_space': 'xyz', 'object_classes': 'cube',
        'primitives': 'push', 'camera_type': 'sim'}
LOSS_RTOL = 1e-4


def _traj(seed, t=T, ncam=NCAM):
    import cv2
    rng = np.random.RandomState(seed)
    frames = np.stack([
        [cv2.GaussianBlur(rng.randint(0, 255, (H, W, 3), np.uint8),
                          (0, 0), 2) for _ in range(ncam)]
        for _ in range(t)])
    states = rng.randn(t, 3).astype(np.float32)
    actions = rng.randn(t, 3).astype(np.float32)
    return frames, states, actions


def _write_robonet(directory, n, encoding='jpeg', lengths=None):
    for i in range(n):
        frames, states, actions = _traj(i, t=(lengths or {}).get(i, T))
        t_f2h.save_hdf5(str(directory / 'traj{}.hdf5'.format(i)),
                        {'term_t': len(frames) - 1},
                        {'images': frames, 'state': states},
                        {'actions': actions}, dict(META),
                        video_encoding=encoding, t_index=i)


def _npy_video(imgs, temp_name_append):
    buf = io.BytesIO()
    np.save(buf, np.asarray(imgs))
    return np.frombuffer(buf.getvalue(), np.uint8)


def _npy_mimread(data, format=None, memtest=None):
    assert format == 'mp4'
    return list(np.load(io.BytesIO(bytes(data))))


def _write_bucketed(directory, n=6):
    saver = HDF5Saver(str(directory), {'max_num_actions': T}, {'T': T},
                      traj_per_file=2, split=(1.0, 0.0, 0.0))
    rng = np.random.RandomState(0)
    for i in range(n):
        obs = {'images': rng.randint(0, 255, (T, NCAM, H, W, 3), np.uint8),
               'state': rng.randn(T, 5).astype(np.float32)}
        policy_out = [{'actions': rng.randn(4).astype(np.float32)}
                      for _ in range(T - 1)]
        saver.save_traj(i, {}, obs, policy_out)


def _batches(module, directory, **kw):
    reader = module.RoboNetTrajReader(str(directory), seed=5, **kw)
    try:
        return list(reader), reader.skipped, reader.sequence_length
    finally:
        reader.close()


LAYOUTS = ['jpeg', 'jpeg_legacy_bgr', 'mp4', 'bucketed']


@pytest.mark.parametrize('layout', LAYOUTS)
def test_reader_batches_equal_jax(tmp_path, monkeypatch, layout):
    kw = dict(batch_size=2, num_epochs=2)
    if layout == 'bucketed':
        _write_bucketed(tmp_path)
        kw['sequence_length'] = T
    elif layout == 'mp4':
        import imageio
        monkeypatch.setattr(t_f2h, 'serialize_video', _npy_video)
        monkeypatch.setattr(imageio, 'mimread', _npy_mimread)
        _write_robonet(tmp_path, 5, encoding='mp4')
    else:
        _write_robonet(tmp_path, 5)
        if layout == 'jpeg_legacy_bgr':
            kw['channel_order'] = 'legacy_bgr'
    got, skipped, seq = _batches(t_reader, tmp_path, **kw)
    want, jskipped, jseq = _batches(j_reader, tmp_path, **kw)
    assert (skipped, seq) == (jskipped, jseq) == (0, T)
    # two epochs of 5 files (the saver's 6 trajectories) in batches of 2
    assert len(got) == len(want) == (6 if layout == 'bucketed' else 5)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ['actions', 'images', 'state']
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]['images'].shape == (2, T, NCAM, H, W, 3)
    assert got[0]['images'].dtype == np.uint8
    if layout == 'mp4':       # the npy payload is lossless
        frames = sorted((_traj(i)[0] for i in range(5)),
                        key=lambda f: f.tobytes())
        assert any(np.array_equal(got[0]['images'][0], f) for f in frames)


def test_discover_and_skipped_equal_jax(tmp_path):
    for module in (t_reader, j_reader):
        with pytest.raises(FileNotFoundError, match='no hdf5 trajectories'):
            module.discover(str(tmp_path))
    (tmp_path / 'flat').mkdir()
    _write_robonet(tmp_path / 'flat', 4, lengths={1: T - 2, 3: T - 1})
    _write_bucketed(tmp_path / 'buckets', n=4)
    for directory, layout, n in (('flat', 'robonet', 4),
                                 ('buckets', 'bucketed', 2)):
        got = t_reader.discover(str(tmp_path / directory))
        assert got == j_reader.discover(str(tmp_path / directory))
        assert got[0] == layout and len(got[1]) == n
    for kw in ({}, {'sequence_length': T}):
        got = _batches(t_reader, tmp_path / 'flat', batch_size=1,
                       num_epochs=1, shuffle=False, **kw)
        want = _batches(j_reader, tmp_path / 'flat', batch_size=1,
                        num_epochs=1, shuffle=False, **kw)
        assert got[1:] == want[1:] == (2, T)
        assert len(got[0]) == len(want[0]) == 2
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g['images'], w['images'])


def test_reader_errors_reach_the_caller(tmp_path, monkeypatch):
    _write_robonet(tmp_path, 2)
    with open(tmp_path / 'traj1.hdf5', 'r+b') as f:
        f.seek(0)
        f.write(b'\0' * 64)                  # no longer an HDF5 file
    reader = t_reader.RoboNetTrajReader(str(tmp_path), 1, num_epochs=1,
                                        shuffle=False)
    with pytest.raises(OSError):
        list(reader)
    reader.close()
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='needs h5py'):
        t_reader.RoboNetTrajReader(str(tmp_path), 1)


# -- the trainer on HDF5 trajectories ---------------------------------------------

B, SEQ, STEPS, LR = 2, 5, 3, 1e-3
FEATURES = (8, 16, 16)
FLAGS = ['--batch_size', str(B), '--sequence_length', str(SEQ),
         '--image_height', str(H), '--image_width', str(W),
         '--num_masks', '3', '--enc_features', *map(str, FEATURES),
         '--lstm_kernel', '3', '--camera', '1', '--ss_k', str(SS_K),
         '--steps', str(STEPS), '--lr', str(LR)]


def test_trainer_on_hdf5_matches_jax(tmp_path):
    _write_robonet(tmp_path, 8)
    targs = ttrain.build_argparser().parse_args(
        FLAGS + ['--data_dir', str(tmp_path), '--device', 'cpu'])
    jargs = jtrain.build_argparser().parse_args(
        FLAGS + ['--data_dir', str(tmp_path)])
    tb, jb = ttrain.record_batches(targs), jtrain.record_batches(jargs)
    batches = []
    for _ in range(STEPS):
        got, want = next(tb), next(jb)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        batches.append(got)
    assert batches[0]['images'].shape == (B, SEQ, H, W, 3)

    kw = _model_kw(dict(std_factor=0))
    jm = JaxPredictor(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
                     jnp.zeros((1, SEQ - 1, 3)), jnp.zeros((1, 2, 3)))
    tm = CDNAPredictor((H, W), **kw)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=min(200, STEPS // 10 + 1),
        decay_steps=max(STEPS, 2))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=1e-5))
    loss_fn = jtrain.make_loss_fn(jm, 2, ss_k=SS_K)

    @jax.jit
    def jax_step(params, opt_state, batch, rng, step):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, rng, step)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    ttx = ttrain.ClippedAdamW(ttrain._named_params(tm),
                              ttrain.training_schedule(targs))
    tstep = ttrain.make_train_step(tm, ttx, 2, ss_k=SS_K)
    opt_state = tx.init(params)
    losses = []
    for step, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, jloss = jax_step(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
            key, jnp.asarray(float(step)))
        mask, _ = _draws(key, step, 0)
        tmet = tstep({k: torch.tensor(v) for k, v in batch.items()}, step,
                     gt_mask=torch.tensor(mask))
        losses.append((float(tmet['loss']), float(jloss)))
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.all(np.isfinite(got))


def test_smoke_trains_from_hdf5_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke
    args = ttrain.build_argparser().parse_args(
        FLAGS + ['--data_dir', str(tmp_path / 'hdf5'), '--device', 'cpu',
                 '--log_every', '1'])
    history, wall = chip_smoke.train_from_hdf5(args)
    assert len(history) == STEPS and wall > 0
    assert np.isfinite([h['loss'] for h in history]).all()
    buckets = os.listdir(str(tmp_path / 'hdf5' / 'hdf5' / 'train'))
    assert len(buckets) == chip_smoke.HDF5_TRAJS // chip_smoke.HDF5_PER_FILE

    def diverged(args):
        return [dict(h, loss=float('nan')) for h in history], None
    monkeypatch.setattr(ttrain, 'train', diverged)
    with pytest.raises(AssertionError, match='training from HDF5'):
        chip_smoke.train_from_hdf5(args)
