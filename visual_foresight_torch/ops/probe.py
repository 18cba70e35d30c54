"""Toolchain probe: the smallest kernel, built and launched before any other.

Counterpart of the Pallas kernel ``add_one`` in
``scripts/pallas_device_probe.py`` (``x + 1`` on an (8, 128) f32 array):
``csrc/probe_add_one.cu`` adds one to any f32 tensor.  A broken compiler,
loader or launch so shows up at the smallest step.

Dispatch is by the device of the tensor: a CUDA tensor launches the kernel or
raises; a CPU tensor takes :func:`add_one_reference`.
"""

import ctypes
import functools

import torch

from visual_foresight_torch.ops import _build

SOURCE = 'probe_add_one.cu'
PROBE_SHAPE = (8, 128)


def add_one_reference(x):
    """Plain version: ``x + 1``."""
    return x + 1


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its ctypes signature."""
    fn = _build.load(SOURCE).probe_add_one
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def add_one(x):
    """``x + 1`` for a contiguous float32 tensor of any shape.  On a CUDA
    device it launches ``csrc/probe_add_one.cu`` and counts the launch in
    ``add_one.launches``."""
    if x.device.type == 'cpu':
        return add_one_reference(x)
    if x.device.type != 'cuda':
        raise ValueError('no add_one kernel for device {}'.format(x.device))
    if x.dtype != torch.float32:
        raise ValueError('add_one takes float32, got {}'.format(x.dtype))
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    fn = _kernel()
    out = torch.empty_like(x)
    if not x.numel():
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError('add_one kernel launch failed: cudaError {}'.format(
            err))
    add_one.launches += 1
    return out


add_one.launches = 0


def toolchain_probe(device='cuda'):
    """The probe's stage 1: ``add_one`` on zeros of ``PROBE_SHAPE``; raises
    unless every element comes back exactly 1."""
    y = add_one(torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=device))
    if not bool((y == 1.0).all()):
        raise RuntimeError('toolchain probe: add_one(0) is not 1 everywhere')
    return y
