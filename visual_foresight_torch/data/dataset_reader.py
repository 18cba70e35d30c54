"""Manifest-driven TFRecord dataset reader.

The port's own copy of ``visual_foresight_tpu/data/dataset_reader.py``, with
its names and its stream: records are decoded with the pure-Python codec in
``tfrecord_io``, and one producer thread behind a queue of 4 assembles
shuffled numpy batches (``random.Random(1234 + epoch)`` created once, a
swap-pop buffer of ``buffer_size``).  Given the files and the hparams, the
batches are those of the JAX package's reader, bit for bit.  The trainers
move them to the card themselves (``data/fused_ingest.py::device_ingest``).

``ds['images', 'train']`` returns a batch; the keys ``state``, ``actions``
and ``images`` are remapped as the reference's reader remaps them, the
cameras concatenated on axis 2.  ``Jpeg`` features need OpenCV, imported
where they are decoded.
"""

import glob
import os
import pickle as pkl
import queue
import random
import threading
import weakref

import numpy as np

from visual_foresight_torch.utils.hparams import HParams
from .tfrecord_io import decode_example, tfrecord_iterator


def _mult_elems(tup):
    prod = 1
    for t in tup:
        prod *= t
    return prod


def _stop_producers(producers):
    """Signal and join prefetch threads (module-level so weakref.finalize
    holds no reference to the dataset itself)."""
    for stop, _ in producers:
        stop.set()
    for _, thread in producers:
        thread.join(timeout=3.0)
    del producers[:]


class BaseVideoDataset:
    MODES = ['train', 'test', 'val']

    def __init__(self, directory, batch_size, hparams_dict=None):
        if not os.path.exists(directory):
            raise FileNotFoundError('base directory {} does not exist'.format(directory))
        self._base_dir = directory
        self._batch_size = batch_size
        self._hparams = self._get_default_hparams().override_from_dict(
            hparams_dict or {})
        self._read_manifest()

        self._files = {}
        for m in self.MODES:
            fnames = sorted(glob.glob('{}/{}/*.tfrecords'.format(directory, m)))
            if fnames:
                self._files[m] = fnames
            else:
                print('Warning: dataset has no files for mode {}'.format(m))
        self._iterators = {}
        self._current = {}   # mode -> (batch dict, keys served from it)
        # producer bookkeeping: threads must be stopped before interpreter
        # teardown — a daemon thread abandoned inside native decode code
        # (cv2) aborts process exit when other shared libraries shift the
        # fini order.  weakref.finalize runs at gc or exit, whichever first.
        self._producers = []
        self._finalizer = weakref.finalize(
            self, _stop_producers, self._producers)

    @staticmethod
    def _get_default_hparams():
        return HParams(shuffle=True, num_epochs=None, buffer_size=512,
                       compressed=True, sequence_length=None,
                       num_reader_threads=2)

    def _read_manifest(self):
        manifest_path = os.path.join(self._base_dir, 'manifest.pkl')
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError('no manifest.pkl in {}'.format(self._base_dir))
        with open(manifest_path, 'rb') as f:
            manifest = pkl.load(f)
        self._sequence_keys = manifest['sequence_data'] or {}
        self._metadata_keys = manifest['traj_metadata'] or {}
        self._T = self._hparams.sequence_length or manifest['T'] or 0

    # -- decoding ---------------------------------------------------------------
    def _decode_traj(self, payload):
        """Decode one serialized Example into {key: np.ndarray} with sequence
        keys stacked over time as (T, ...)."""
        raw = decode_example(payload)
        out = {}
        for k, (shape, dtype) in self._metadata_keys.items():
            out[k] = self._reshape_feature(raw[k], shape, dtype)
        for k, (shape, dtype) in self._sequence_keys.items():
            steps = [self._reshape_feature(raw['{}/{}'.format(t, k)], shape, dtype)
                     for t in range(self._T)]
            out[k] = np.stack(steps, axis=0)
        return out

    @staticmethod
    def _reshape_feature(kind_values, shape, dtype):
        kind, values = kind_values
        if dtype == 'Byte':
            assert kind == 'bytes'
            arr = np.frombuffer(values[0], dtype=np.uint8)
            return arr.reshape(shape)
        if dtype == 'Jpeg':
            try:
                import cv2
            except ImportError as e:
                raise ImportError('Jpeg features need OpenCV (cv2), which '
                                  'does not import here') from e
            assert kind == 'bytes'
            buf = np.frombuffer(values[0], dtype=np.uint8)
            bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            return bgr[..., ::-1]  # stored as RGB-content JPEG
        if dtype == 'Float':
            return np.asarray(values, dtype=np.float32).reshape(shape)
        if dtype == 'Int':
            return np.asarray(values, dtype=np.int64).reshape(shape)
        raise ValueError('unknown dtype {}'.format(dtype))

    # -- pipeline ------------------------------------------------------------------
    def _traj_stream(self, mode):
        """Generator of decoded trajectories honoring shuffle/repeat."""
        files = list(self._files[mode])
        epoch = 0
        compression = 'GZIP' if self._hparams.compressed else None
        shuffle_buf = []
        rng = random.Random(1234 + epoch)
        while True:
            if self._hparams.shuffle:
                rng.shuffle(files)
            for fname in files:
                for payload in tfrecord_iterator(fname, compression):
                    traj = self._decode_traj(payload)
                    if not self._hparams.shuffle:
                        yield traj
                        continue
                    shuffle_buf.append(traj)
                    if len(shuffle_buf) >= self._hparams.buffer_size:
                        idx = rng.randrange(len(shuffle_buf))
                        shuffle_buf[idx], shuffle_buf[-1] = \
                            shuffle_buf[-1], shuffle_buf[idx]
                        yield shuffle_buf.pop()
            epoch += 1
            if self._hparams.num_epochs and epoch >= self._hparams.num_epochs:
                break
        while shuffle_buf:
            yield shuffle_buf.pop()

    def _batch_stream(self, mode):
        """Background-thread prefetching batch generator."""
        q = queue.Queue(maxsize=4)
        sentinel = object()
        stop = threading.Event()

        def interruptible_put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            batch = []
            try:
                for traj in self._traj_stream(mode):
                    if stop.is_set():
                        return
                    batch.append(traj)
                    if len(batch) == self._batch_size:
                        collated = {
                            k: np.stack([b[k] for b in batch]) for k in batch[0]}
                        if not interruptible_put(collated):
                            return
                        batch = []
            finally:
                if not interruptible_put(sentinel):
                    # stopped with a full queue: displace one batch so a
                    # consumer blocked in q.get() still terminates
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait(sentinel)
                    except queue.Full:
                        pass

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        self._producers.append((stop, thread))
        while True:
            item = q.get()
            if item is sentinel:
                return
            yield item

    # -- public API -------------------------------------------------------------------
    def _map_key(self, batch, key):
        if key in ('state', 'endeffector_pos'):
            return batch['env/state']
        if key == 'actions':
            return batch['policy/actions']
        if key == 'images':
            imgs, i = [], 0
            while 'env/image_view{}/encoded'.format(i) in batch:
                imgs.append(batch['env/image_view{}/encoded'.format(i)][:, :, None])
                i += 1
            if i == 0:
                raise ValueError('no image tensors in batch')
            return imgs[0] if i == 1 else np.concatenate(imgs, 2)
        if key in batch:
            return batch[key]
        raise NotImplementedError('key {} not in batch with keys {}'.format(
            key, list(batch.keys())))

    def next_batch(self, mode='train'):
        """Advance to (and return) the next raw batch dict for ``mode``."""
        if mode not in self._files:
            raise ValueError('mode {} not valid; dataset has {}'.format(
                mode, list(self._files.keys())))
        if mode not in self._iterators:
            self._iterators[mode] = self._batch_stream(mode)
        batch = next(self._iterators[mode])
        self._current[mode] = (batch, set())
        return batch

    def get(self, key, mode='train'):
        """Return ``key`` from the current batch of ``mode``.

        Reference semantics (``examples/dataset_reader.py:202-216``): tensors
        fetched for different keys belong to the SAME batch — the reference
        builds them as outputs of one tf.data iterator.  The iterator only
        advances when a key is requested a second time (or via
        ``next_batch``), so ``ds['images','train']`` + ``ds['actions','train']``
        are guaranteed to be aligned.
        """
        if mode not in self._current or key in self._current[mode][1]:
            self.next_batch(mode)
        batch, served = self._current[mode]
        served.add(key)
        return self._map_key(batch, key)

    def numpy_iterator(self, keys=('images', 'actions', 'state'), mode='train'):
        """Yield dicts of numpy batches for the requested keys."""
        for batch in self._batch_stream(mode):
            yield {k: self._map_key(batch, k) for k in keys}

    def __getitem__(self, item):
        if isinstance(item, tuple):
            if len(item) != 2:
                raise KeyError('index format: [key, mode] or [key]')
            key, mode = item
            return self.get(key, mode)
        return self.get(item)

    def close(self):
        """Stop prefetch threads; safe to call more than once."""
        _stop_producers(self._producers)

    @property
    def batch_size(self):
        return self._batch_size

    @property
    def sequence_length(self):
        return self._T
