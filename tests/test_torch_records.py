"""Port parity: the record path, ``visual_foresight_torch``'s against the JAX
package's on the same trajectories.

- The CRC32C fallback (``tfrecord_io.crc32c_numpy``) equals
  ``google_crc32c`` on random payloads; records written with it read back
  with their checksums validated.
- ``encode_example``/``decode_example`` round-trip both ways between the two
  packages, and encode to the same bytes.
- A shard written by either package's ``GeneralAgentSaver`` reads back
  through the other's reader; the decompressed record streams are equal
  byte for byte (``gzip.open`` stamps the time into each file's header, so
  the files themselves differ); ``manifest.pkl`` and ``manifest.txt`` are
  equal; ``record_worker`` writes the same streams.
- ``BaseVideoDataset`` batches equal the JAX reader's bit for bit, shuffle
  on (a small buffer and the default one) and off, one and two cameras, over
  several epochs; ``get`` serves every key of one batch before it advances,
  as JAX's does.

Shards are tiny: 8 x 12 frames, T of 4-6, at most 8 trajectories.
Everything is exact: no tolerance."""

import gzip
import os
import pickle
import queue
import sys

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.utils import traj_saver as ttraj
from visual_foresight_torch.data import dataset_reader as treader
from visual_foresight_torch.data import tfrecord_io as tio
from visual_foresight_tpu.agent.utils import traj_saver as jtraj
from visual_foresight_tpu.data import dataset_reader as jreader
from visual_foresight_tpu.data import tfrecord_io as jio

H, W, SDIM, ADIM = 8, 12, 3, 3
PACKAGES = {'port': (ttraj, treader, tio), 'jax': (jtraj, jreader, jio)}


def trajectory(seed, T, ncam=1):
    """(agent_data, obs, policy_out) of one random trajectory."""
    rng = np.random.RandomState(seed)
    agent_data = {'term_t': T - 1, 'traj_ok': True,
                  'goal_reached': bool(seed % 2)}
    obs = {'images': rng.randint(0, 255, (T, ncam, H, W, 3), np.uint8),
           'state': rng.randn(T, SDIM).astype(np.float64)}
    policy_out = [{'actions': rng.randn(ADIM).astype(np.float32)}
                  for _ in range(T)]
    return agent_data, obs, policy_out


def write_shards(directory, package='port', n_traj=8, T=5, ncam=1,
                 traj_per_file=4):
    """Write ``n_traj`` trajectories with ``package``'s saver; returns them."""
    saver = PACKAGES[package][0].GeneralAgentSaver(
        str(directory), T, traj_per_file=traj_per_file,
        split=(1.0, 0.0, 0.0))
    trajs = [trajectory(i, T, ncam) for i in range(n_traj)]
    for agent_data, obs, policy_out in trajs:
        saver.save_traj(dict(agent_data), obs, policy_out)
    saver.flush()
    return trajs


def record_stream(directory):
    """The decompressed bytes of every train shard, in file order."""
    files = sorted(os.listdir(os.path.join(str(directory), 'train')))
    return [(f, gzip.open(os.path.join(str(directory), 'train', f)).read())
            for f in files]


# -- crc32c and the Example codec ----------------------------------------------

@pytest.mark.parametrize('n', [0, 1, 7, 255, 256, 257, 4099, 65536 + 13])
def test_crc32c_fallback_matches_google_crc32c(n):
    import google_crc32c
    data = np.random.RandomState(n).bytes(n)
    want = int.from_bytes(google_crc32c.Checksum(data).digest(), 'big')
    assert tio.crc32c_numpy(data) == want


def test_records_written_with_the_fallback_validate(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, 'crc32c_impl', lambda: tio.crc32c_numpy)
    payloads = [np.random.RandomState(i).bytes(100 * i + 3) for i in range(4)]
    path = str(tmp_path / 'shard.tfrecords')
    with tio.TFRecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    with gzip.open(path) as f:
        assert list(jio.read_records(f, validate=True)) == payloads
    # and the JAX writer (google_crc32c) writes the same stream
    jpath = str(tmp_path / 'jax.tfrecords')
    with jio.TFRecordWriter(jpath) as w:
        for p in payloads:
            w.write(p)
    assert gzip.open(path).read() == gzip.open(jpath).read()


def _features(io):
    return {'img': io.bytes_feature(b'\x00\x01\xff' * 5),
            'empty': io.bytes_feature(b''),
            'f': io.float_feature([1.5, -2.25, 3e-8, np.float32(7.1)]),
            'i': io.int64_feature([0, 1, -1, 2 ** 40, -2 ** 62]),
            'none': io.int64_feature([])}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_example_codec_round_trips_between_packages(writer):
    w_io = PACKAGES[writer][2]
    r_io = PACKAGES['jax' if writer == 'port' else 'port'][2]
    payload = w_io.encode_example(_features(w_io))
    assert payload == r_io.encode_example(_features(r_io))
    got, want = r_io.decode_example(payload), w_io.decode_example(payload)
    assert set(got) == set(want) == set(_features(w_io))
    for k in got:
        assert got[k][0] == want[k][0]
        if got[k][0] == 'bytes':
            assert got[k][1] == want[k][1]
        else:
            np.testing.assert_array_equal(got[k][1], want[k][1])
            assert got[k][1].dtype == want[k][1].dtype
    assert set(r_io.decode_example(payload, keys={'f', 'i'})) == {'f', 'i'}


# -- shards ---------------------------------------------------------------------

@pytest.mark.parametrize('ncam', [1, 2])
def test_shards_and_manifests_equal_jax(tmp_path, ncam):
    write_shards(tmp_path / 'port', 'port', ncam=ncam)
    write_shards(tmp_path / 'jax', 'jax', ncam=ncam)
    port, jax_ = record_stream(tmp_path / 'port'), record_stream(tmp_path / 'jax')
    assert [f for f, _ in port] == [f for f, _ in jax_] == \
        ['traj_0_to_3.tfrecords', 'traj_4_to_7.tfrecords']
    assert all(a == b for (_, a), (_, b) in zip(port, jax_))
    for name in ('manifest.pkl', 'manifest.txt'):
        with open(tmp_path / 'port' / name, 'rb') as a, \
                open(tmp_path / 'jax' / name, 'rb') as b:
            assert a.read() == b.read(), name
    with open(tmp_path / 'port' / 'manifest.pkl', 'rb') as f:
        manifest = pickle.load(f)
    assert manifest['T'] == 5 and 'policy/actions' in manifest['sequence_data']


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_shard_reads_back_through_the_other_reader(tmp_path, writer):
    trajs = write_shards(tmp_path, writer)
    reader = PACKAGES['jax' if writer == 'port' else 'port'][1]
    ds = reader.BaseVideoDataset(str(tmp_path), 8,
                                 hparams_dict={'shuffle': False})
    images, state = ds['images', 'train'], ds['state', 'train']
    actions, reached = ds['actions', 'train'], ds['goal_reached', 'train']
    ds.close()
    for i, (agent_data, obs, policy_out) in enumerate(trajs):
        np.testing.assert_array_equal(images[i], obs['images'])
        np.testing.assert_array_equal(state[i],
                                      obs['state'].astype(np.float32))
        np.testing.assert_array_equal(
            actions[i], np.stack([p['actions'] for p in policy_out]))
        assert reached[i, 0] == int(agent_data['goal_reached'])


def test_record_worker_writes_what_jax_writes(tmp_path):
    for name, package in (('port', ttraj), ('jax', jtraj)):
        q = queue.Queue()
        for agent_data, obs, policy_out in (trajectory(i, 4)
                                            for i in range(3)):
            q.put((dict(agent_data), obs, policy_out))
        q.put(None)
        np.random.seed(0)
        package.record_worker(q, str(tmp_path / name), 4, False, 2,
                              split=(0.5, 0.25, 0.25))
    for mode in ('train', 'test', 'val'):
        got = sorted(os.listdir(tmp_path / 'port' / mode))
        assert got == sorted(os.listdir(tmp_path / 'jax' / mode))
        for f in got:
            assert gzip.open(tmp_path / 'port' / mode / f).read() == \
                gzip.open(tmp_path / 'jax' / mode / f).read()


def test_jpeg_features_without_opencv_raise_and_name_it(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        treader.BaseVideoDataset._reshape_feature(('bytes', [b'\xff']),
                                                  (H, W, 3), 'Jpeg')
    with pytest.raises(ImportError, match='cv2'):
        ttraj.jpeg_encode(np.zeros((H, W, 3), np.uint8))


# -- the reader's stream -------------------------------------------------------------

def _batches(reader, directory, hparams, n, keys=('images', 'actions',
                                                  'state')):
    ds = reader.BaseVideoDataset(str(directory), 3, hparams_dict=hparams)
    it = ds.numpy_iterator(keys=keys)
    out = [next(it) for _ in range(n)]
    ds.close()
    return out


@pytest.mark.parametrize('hparams', [
    {'shuffle': False},
    {'shuffle': True, 'buffer_size': 4},
    {'shuffle': True},
    {'shuffle': True, 'buffer_size': 3, 'num_epochs': 2},
], ids=['shuffle-off', 'shuffle-buffer-4', 'shuffle-default-buffer',
        'shuffle-two-epochs'])
@pytest.mark.parametrize('ncam', [1, 2])
def test_batches_equal_jax_bit_for_bit(tmp_path, hparams, ncam):
    write_shards(tmp_path, 'port', n_traj=8, T=4, ncam=ncam,
                 traj_per_file=3)
    # two-epoch pass: 16 trajectories make 5 batches of 3 (the last one is
    # dropped); the others repeat forever
    n = 5 if hparams.get('num_epochs') else 7
    got = _batches(treader, tmp_path, hparams, n)
    want = _batches(jreader, tmp_path, hparams, n)
    for g, w in zip(got, want):
        for k in ('images', 'actions', 'state'):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]['images'].shape == (3, 4, ncam, H, W, 3)


def test_get_serves_one_batch_per_key_as_jax_does(tmp_path):
    write_shards(tmp_path, 'port', n_traj=8, T=4)
    calls = [('images', 'train'), ('actions', 'train'), ('state', 'train'),
             ('images', 'train'), ('state', 'train'), ('state', 'train')]
    seen = {}
    for name, reader in (('port', treader), ('jax', jreader)):
        ds = reader.BaseVideoDataset(str(tmp_path), 2,
                                     hparams_dict={'buffer_size': 4})
        seen[name] = [ds[c] for c in calls] + [ds.get('images')]
        ds.close()
    for g, w in zip(seen['port'], seen['jax']):
        np.testing.assert_array_equal(g, w)
    images, actions, state, images2, state2, state3, images3 = seen['port']
    # the first three keys come from one batch, so a row's frames, actions
    # and states belong to one trajectory; a key asked again advances
    trajs = {tuple(trajectory(i, 4)[1]['images'][0, 0, 0, 0]): i
             for i in range(8)}
    for b in range(2):
        i = trajs[tuple(images[b, 0, 0, 0, 0])]
        np.testing.assert_array_equal(
            state[b], trajectory(i, 4)[1]['state'].astype(np.float32))
    assert not np.array_equal(images, images2)
    assert not np.array_equal(state2, state3)
