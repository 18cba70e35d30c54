"""RoboNet-format HDF5 trajectory reader feeding the training pipeline.

The port's counterpart of ``visual_foresight_tpu/data/robonet_reader.py``,
with the same draws and the same batches.  It reads the two HDF5 layouts:

* **traj-per-file** (``utils/file_2_hdf5.py``, the RoboNet release format;
  reference ``visual_mpc/utils/file_2_hdf5.py:15-42``): groups ``env``
  (``cam{n}_video`` holding one mp4 ``frames`` dataset or per-step
  ``frame{t}`` JPEGs, plus ``state``), ``policy`` (``actions``) and
  ``metadata`` attrs.
* **bucketed** (``agent/utils/hdf5_saver.py``, reference
  ``record_saver.py:184-235``): ``hdf5/{train,val,test}/traj_XtoY.h5``
  files holding ``traj{i}/{images,states,actions,pad_mask}`` datasets.

Batches come out in the record path's schema (``images`` uint8
``(B, T, ncam, H, W, 3)``, float32 ``state`` and ``actions``), so
``train_predictor --data_dir`` takes them as it takes TFRecord batches.
Decoding runs in a stoppable prefetch thread; an error there (a missing
package, a corrupt file) is raised to the consumer at its next batch, where
the JAX reader's thread ends the stream.  ``h5py`` (checked when the reader
is built), ``cv2`` (JPEG frames) and ``imageio`` (mp4 frames) are imported
where they are used, each with an error that names it.
"""

import glob
import os
import queue
import random
import threading
import weakref

import numpy as np

from visual_foresight_torch.data.dataset_reader import _stop_producers


def _import(name, what):
    try:
        return __import__(name)
    except ImportError as e:
        raise ImportError('the RoboNet reader needs {} to read {}'.format(
            name, what)) from e


def _decode_jpeg(buf, swap=False):
    """JPEG bytes -> RGB frame.  The reference and RoboNet writers
    (``visual_mpc/utils/file_2_hdf5.py:21``, the byte-compatible
    ``utils/file_2_hdf5.serialize_image``) encode the RGB array with no
    swap, so ``cv2.imdecode`` with no swap returns RGB directly.  Files of an
    exporter that swapped to BGR at encode time need ``swap=True``
    (``channel_order='legacy_bgr'`` of :class:`RoboNetTrajReader`)."""
    cv2 = _import('cv2', 'JPEG frames')
    arr = cv2.imdecode(np.frombuffer(np.asarray(buf), np.uint8),
                       cv2.IMREAD_COLOR)
    return arr[:, :, ::-1] if swap else arr


def _decode_mp4(buf):
    imageio = _import('imageio', 'mp4 frames')
    frames = imageio.mimread(np.asarray(buf).tobytes(), format='mp4',
                             memtest=False)
    return np.stack(frames)[..., :3]


def _load_robonet_traj(path, swap_jpeg=False):
    """One traj-per-file RoboNet h5 -> {'images', 'state', 'actions'}."""
    h5py = _import('h5py', 'HDF5 trajectories')
    with h5py.File(path, 'r') as f:
        env = f['env']
        n_cams = int(env.attrs.get('n_cams', 1))
        encoding = env.attrs.get('cam_encoding', 'jpeg')
        cams = []
        for n in range(n_cams):
            grp = env['cam{}_video'.format(n)]
            if encoding == 'mp4':
                cams.append(_decode_mp4(grp['frames'][()]))
            else:
                T = len(grp)
                cams.append(np.stack(
                    [_decode_jpeg(grp['frame{}'.format(t)][()], swap_jpeg)
                     for t in range(T)]))
        images = np.stack(cams, axis=1)   # (T, ncam, H, W, 3)
        states = np.asarray(env['state'][()] if 'state' in env
                            else env['states'][()], np.float32)
        pol = f['policy']
        actions = np.asarray(pol['actions'][()], np.float32)
    return {'images': images.astype(np.uint8), 'state': states,
            'actions': actions}


def _load_bucketed_file(path):
    """One HDF5Saver bucket file -> list of traj dicts."""
    h5py = _import('h5py', 'HDF5 trajectories')
    out = []
    with h5py.File(path, 'r') as f:
        i = 0
        while 'traj{}'.format(i) in f:
            g = f['traj{}'.format(i)]
            images = np.asarray(g['images'][()], np.uint8)
            if images.ndim == 4:          # (T, H, W, 3): single camera
                images = images[:, None]
            traj = {
                'images': images,
                'state': np.asarray(g['states'][()], np.float32),
                'actions': np.asarray(g['actions'][()], np.float32),
            }
            if 'pad_mask' in g:
                # HDF5Saver zero-pads to max_num_actions; serve real steps
                valid = int(np.asarray(g['pad_mask'][()]).sum())
                traj = {k: v[:max(valid, 1)] for k, v in traj.items()}
            out.append(traj)
            i += 1
    return out


def discover(directory, mode='train'):
    """(layout, files): traj-per-file h5s in the dir itself, or the
    HDF5Saver bucket tree ``<dir>/hdf5/<mode>/``."""
    bucket_dir = os.path.join(directory, 'hdf5', mode)
    buckets = sorted(glob.glob(os.path.join(bucket_dir, '*.h5'))
                     + glob.glob(os.path.join(bucket_dir, '*.hdf5')))
    if buckets:
        return 'bucketed', buckets
    flat = sorted(glob.glob(os.path.join(directory, '*.hdf5'))
                  + glob.glob(os.path.join(directory, '*.h5')))
    if flat:
        return 'robonet', flat
    raise FileNotFoundError('no hdf5 trajectories under {}'.format(directory))


class RoboNetTrajReader:
    """Iterator of training batches drawn from HDF5 trajectories.

    Trajectories are cut to a common length, set by ``sequence_length`` or
    else by the first trajectory read (RoboNet mixes sources); shorter ones
    are skipped and counted (``skipped``).
    """

    def __init__(self, directory, batch_size, mode='train', num_epochs=0,
                 shuffle=True, sequence_length=None, seed=1234,
                 channel_order='rgb'):
        if channel_order not in ('rgb', 'legacy_bgr'):
            raise ValueError("channel_order must be 'rgb' (reference/RoboNet "
                             "convention) or 'legacy_bgr' (files of an "
                             "exporter that swapped to BGR)")
        self._swap_jpeg = channel_order == 'legacy_bgr'
        self._layout, self._files = discover(directory, mode)
        _import('h5py', 'HDF5 trajectories')
        self._batch = batch_size
        self._epochs = num_epochs
        self._shuffle = shuffle
        self._T = sequence_length
        self._rng = random.Random(seed)
        self._skipped = 0
        self._producers = []
        # stop the prefetch thread before interpreter teardown: a daemon
        # thread abandoned inside native decode (cv2/h5py) aborts the exit
        self._finalizer = weakref.finalize(
            self, _stop_producers, self._producers)
        self._q = queue.Queue(maxsize=4)
        self._sentinel = object()
        self._error = None
        self._start()

    def _traj_stream(self):
        epoch = 0
        while True:
            files = list(self._files)
            if self._shuffle:
                self._rng.shuffle(files)
            for path in files:
                if self._layout == 'robonet':
                    trajs = [_load_robonet_traj(path, self._swap_jpeg)]
                else:
                    trajs = _load_bucketed_file(path)
                for tr in trajs:
                    T = tr['images'].shape[0]
                    if self._T is None:
                        self._T = T
                    if T < self._T:
                        self._skipped += 1
                        continue
                    yield {'images': tr['images'][:self._T],
                           'state': tr['state'][:self._T],
                           'actions': tr['actions'][:self._T]}
            epoch += 1
            if self._epochs and epoch >= self._epochs:
                return

    def _start(self):
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            batch = []
            try:
                for tr in self._traj_stream():
                    if stop.is_set():
                        return
                    batch.append(tr)
                    if len(batch) == self._batch:
                        put({k: np.stack([b[k] for b in batch])
                             for k in batch[0]})
                        batch = []
            except Exception as e:      # noqa: BLE001 (raised in __next__)
                self._error = e
            finally:
                if not put(self._sentinel):
                    # stopped with a full queue: make room so a blocked
                    # consumer still sees the sentinel
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        self._q.put_nowait(self._sentinel)
                    except queue.Full:
                        pass

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        self._producers.append((stop, thread))

    @property
    def sequence_length(self):
        return self._T

    @property
    def skipped(self):
        return self._skipped

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        _stop_producers(self._producers)
