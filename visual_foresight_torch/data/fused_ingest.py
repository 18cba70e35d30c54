"""Fused-ingest loader: native host decode, then the cast on the card.

The port's counterpart of ``visual_foresight_tpu/data/fused_ingest.py``,
with its names and its contract:

* **Host (C++, ``native/ingest.cpp``, the port's own copy)**: streaming
  GZIP TFRecord shards, ``tf.train.Example`` parsing of only the training
  keys, JPEG or raw image decode (and a bilinear resize where the shard's
  resolution differs), a trajectory shuffle pool, and batch assembly into
  caller-owned numpy buffers.  It is compiled at first use by
  ``ops/_build.py::build_host`` into ``build/native/`` and bound with
  ctypes.
* **Device (``device_ingest``)**: the uint8 batch crosses to the card as
  uint8 (a quarter of the float bytes) and is cast and scaled by 1/255
  there.

Where ``jpeglib.h`` is missing the engine is built without JPEG decoding
(``-DVFI_NO_JPEG``) and reads raw shards only.  ``make_loader`` falls back,
with a WARNING, to the pure-Python ``BaseVideoDataset`` where the engine
cannot be built (no ``g++`` or no ``zlib.h``) or cannot decode the shards'
frames, with the same batch dicts.
"""

import ctypes
import glob
import os
import pickle as pkl
import shutil
import subprocess
import threading

import numpy as np
import torch

SOURCE = 'ingest.cpp'
HEADERS = ('jpeglib.h', 'zlib.h')
_lib = None
_decodes_jpeg = None
_lib_lock = threading.Lock()


def _load_library():
    """Build (if needed) and dlopen the ingest library once per process."""
    global _lib, _decodes_jpeg
    with _lib_lock:
        if _lib is not None:
            return _lib
        from visual_foresight_torch.ops import _build
        flags, libs = engine_build()
        lib = ctypes.CDLL(str(_build.build_host(SOURCE, libs, flags)))
        lib.vfi_open.restype = ctypes.c_void_p
        lib.vfi_open.argtypes = [ctypes.c_char_p]
        lib.vfi_next.restype = ctypes.c_int
        lib.vfi_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p]
        lib.vfi_frames_decoded.restype = ctypes.c_double
        lib.vfi_frames_decoded.argtypes = [ctypes.c_void_p]
        lib.vfi_error.restype = ctypes.c_char_p
        lib.vfi_error.argtypes = [ctypes.c_void_p]
        lib.vfi_close.restype = None
        lib.vfi_close.argtypes = [ctypes.c_void_p]
        _lib, _decodes_jpeg = lib, not flags
        return _lib


def missing_build_tools():
    """What the native engine's build lacks on this machine: ``['g++']``
    where no compiler is on the PATH (``$CXX`` if set), else the headers of
    ``HEADERS`` the compiler does not find.  Empty where it can be built."""
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        return ['g++']
    missing = []
    for header in HEADERS:
        # jpeglib.h uses FILE and size_t without including their headers
        source = '#include <cstddef>\n#include <cstdio>\n#include <{}>\n' \
            .format(header)
        proc = subprocess.run([cxx, '-fsyntax-only', '-x', 'c++', '-'],
                              input=source, capture_output=True, text=True,
                              check=False)
        if proc.returncode:
            missing.append(header)
    return missing


def engine_build():
    """The native engine's build on this machine: (g++ flags, libraries),
    with libjpeg, or without JPEG decoding where ``jpeglib.h`` is missing.
    Raises RuntimeError where ``g++`` or ``zlib.h`` is missing."""
    missing = missing_build_tools()
    if 'g++' in missing or 'zlib.h' in missing:
        raise RuntimeError('the native ingest engine cannot be built here: '
                           'no {}'.format(', '.join(missing)))
    if 'jpeglib.h' in missing:
        return ('-DVFI_NO_JPEG',), ('-lz',)
    return (), ('-ljpeg', '-lz')


def native_available(jpeg=False):
    """Whether the native engine builds here and, with ``jpeg``, decodes
    JPEG frames."""
    try:
        _load_library()
    except (OSError, RuntimeError):
        return False
    return _decodes_jpeg or not jpeg


def _jpeg_coded(directory):
    """Whether the shards under ``directory`` hold JPEG frames (by their
    manifest; False without one)."""
    path = os.path.join(directory, 'manifest.pkl')
    if not os.path.isfile(path):
        return False
    with open(path, 'rb') as f:
        seq = pkl.load(f)['sequence_data']
    return any(dtype == 'Jpeg' for key, (_, dtype) in seq.items()
               if '/encoded' in key)


class FusedTrajLoader:
    """Iterator of ``{'images': u8 (B,T,ncam,H,W,3), 'actions': f32 (B,T,adim),
    'state': f32 (B,T,sdim)}`` batches drawn by the native engine.

    ``image_hw`` overrides the manifest resolution (the native engine resizes
    JPEG shards on the fly); raw shards must already match the manifest.
    """

    def __init__(self, directory, batch_size, mode='train', num_epochs=0,
                 shuffle=True, threads=2, seed=1234, image_hw=None,
                 pool_size=256):
        manifest_path = os.path.join(directory, 'manifest.pkl')
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError('no manifest.pkl in {}'.format(directory))
        with open(manifest_path, 'rb') as f:
            manifest = pkl.load(f)
        seq = manifest['sequence_data']
        self._T = manifest['T']
        self._batch = batch_size

        image_keys = sorted(k for k in seq if '/encoded' in k)
        if not image_keys:
            raise ValueError('no image keys in manifest: {}'.format(list(seq)))
        self._ncam = len(image_keys)
        ih, iw = seq[image_keys[0]][0][:2]
        if image_hw is not None:
            ih, iw = image_hw
        self._hw = (ih, iw)
        self._sdim = int(np.prod(seq['env/state'][0]))
        self._adim = int(np.prod(seq['policy/actions'][0]))

        files = sorted(glob.glob(os.path.join(directory, mode, '*.tfrecords')))
        if not files:
            raise FileNotFoundError('no {} tfrecords under {}'.format(
                mode, directory))
        self._files = files

        lines = [
            'batch {}'.format(batch_size),
            'T {}'.format(self._T),
            'ncam {}'.format(self._ncam),
            'height {}'.format(ih),
            'width {}'.format(iw),
            'adim {}'.format(self._adim),
            'sdim {}'.format(self._sdim),
            'threads {}'.format(threads),
            'shuffle {}'.format(1 if shuffle else 0),
            'num_epochs {}'.format(num_epochs),
            'pool_size {}'.format(pool_size),
            'seed {}'.format(seed),
            'image_key {}'.format(
                image_keys[0].replace('view0', 'view{c}')),
        ] + ['file {}'.format(f) for f in files]
        lib = _load_library()
        if seq[image_keys[0]][1] == 'Jpeg' and not _decodes_jpeg:
            raise RuntimeError('the native ingest engine was built without '
                               'libjpeg (no jpeglib.h here) and decodes no '
                               'JPEG frames: use the Python reader')
        self._lib = lib
        self._h = ctypes.c_void_p(lib.vfi_open('\n'.join(lines).encode()))
        err = lib.vfi_error(self._h)
        if err:
            raise RuntimeError('ingest engine: {}'.format(err.decode()))

        B, T, N = batch_size, self._T, self._ncam
        self._img = np.empty((B, T, N, ih, iw, 3), np.uint8)
        self._state = np.empty((B, T, self._sdim), np.float32)
        self._act = np.empty((B, T, self._adim), np.float32)

    @property
    def sequence_length(self):
        return self._T

    @property
    def num_files(self):
        return len(self._files)

    def frames_decoded(self):
        return float(self._lib.vfi_frames_decoded(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        rc = self._lib.vfi_next(
            self._h,
            self._img.ctypes.data_as(ctypes.c_void_p),
            self._state.ctypes.data_as(ctypes.c_void_p),
            self._act.ctypes.data_as(ctypes.c_void_p))
        if rc == 1:
            raise StopIteration
        if rc > 0:
            raise RuntimeError('ingest engine: {}'.format(
                self._lib.vfi_error(self._h).decode() or 'rc={}'.format(rc)))
        # rc == 0: full batch; rc < 0: the source drained mid-batch and the
        # leading -rc rows hold the trailing partial batch of a finite-epoch
        # pass (the next call raises StopIteration)
        n = self._img.shape[0] if rc == 0 else -rc
        # copies: the engine refills these buffers on the next call
        return {'images': self._img[:n].copy(),
                'state': self._state[:n].copy(),
                'actions': self._act[:n].copy()}

    def close(self):
        if self._h:
            self._lib.vfi_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def device_ingest(images_u8, dtype=torch.float32, device=None):
    """The device half of the pipeline: uint8 HWC frames (a tensor or a
    numpy array) moved to ``device`` (default: where they are) as uint8,
    then cast to ``dtype`` and multiplied by 1/255 in ``dtype``, as the JAX
    package's ``device_ingest`` does."""
    x = torch.as_tensor(images_u8, device=device)
    return x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                      device=x.device)


def make_loader(directory, batch_size, mode='train', prefer_native=True,
                num_epochs=0, shuffle=True, image_hw=None, **kwargs):
    """Return a batch iterator: the native loader where it builds, else the
    threaded pure-Python reader (the same dict schema, images as uint8)."""
    if prefer_native and native_available(jpeg=_jpeg_coded(directory)):
        return FusedTrajLoader(directory, batch_size, mode=mode,
                               num_epochs=num_epochs, shuffle=shuffle,
                               image_hw=image_hw, **kwargs)
    from .dataset_reader import BaseVideoDataset
    print('WARNING: native ingest unavailable; using pure-Python reader')
    if image_hw is not None:
        raise NotImplementedError(
            'image_hw resize needs the native ingest engine')
    ds = BaseVideoDataset(directory, batch_size, hparams_dict={
        'shuffle': shuffle,
        'num_epochs': num_epochs if num_epochs else None})

    def gen():
        for batch in ds.numpy_iterator(keys=('images', 'actions', 'state'),
                                       mode=mode):
            yield {'images': batch['images'], 'actions': batch['actions'],
                   'state': batch['state']}
    return gen()
