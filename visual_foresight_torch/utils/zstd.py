"""Zstandard decompression with the port's own decoder.

The JAX package's orbax checkpoints hold zstd frames: the OCDBT manifests
and b-tree nodes, and the zarr chunks of every array.  The card machine has
neither the ``zstandard`` package nor, as far as anyone knows, libzstd, so
the port decodes them with ``native/zstd_decode.cpp``, a decoder written
from RFC 8878 that needs nothing but the C++ standard library.  It is
compiled at first use by ``ops/_build.py::build_host`` into
``build/native/`` and bound with ctypes, as ``data/fused_ingest.py`` binds
the ingest engine.  Where ``g++`` is missing, ``decompress`` raises
RuntimeError and names it.

Frames that name a dictionary, and any malformed input, raise ValueError.
"""

import ctypes
import threading

SOURCE = 'zstd_decode.cpp'
FRAME_MAGIC = b'\x28\xb5\x2f\xfd'
_lib = None
_lib_lock = threading.Lock()


def library():
    """Build (if needed) and dlopen the decoder once per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from visual_foresight_torch.ops import _build
        lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
        lib.vfz_decompress.restype = ctypes.c_int
        lib.vfz_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_char_p, ctypes.c_size_t]
        lib.vfz_free.restype = None
        lib.vfz_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def decompress(data):
    """The bytes that the zstd frames of ``data`` (bytes-like: one frame or
    several, skippable frames among them) decode to."""
    lib = library()
    src = bytes(data)
    out, out_n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.vfz_decompress(src, len(src), ctypes.byref(out),
                          ctypes.byref(out_n), err, len(err)):
        raise ValueError('zstd: {}'.format(err.value.decode()))
    try:
        return ctypes.string_at(out, out_n.value)
    finally:
        lib.vfz_free(out)

