"""Toolchain probe: the smallest kernel, built and launched before any other.

Counterpart of the Pallas kernel ``add_one`` in
``scripts/pallas_device_probe.py`` (``x + 1`` on an (8, 128) f32 array):
``csrc/probe_add_one.cu`` adds one to any f32 tensor.  A broken compiler,
loader or launch so shows up at the smallest step.

Dispatch is by ``dispatch.route``: a CUDA tensor launches the kernel or
raises; a CPU tensor takes :func:`add_one_reference`.
"""

import ctypes

import torch

from visual_foresight_torch.ops.dispatch import Entry, route

SOURCE = 'probe_add_one.cu'
PROBE_SHAPE = (8, 128)
_ADD_ONE = Entry(SOURCE, 'probe_add_one',
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])


def add_one_reference(x):
    """Plain version: ``x + 1``."""
    return x + 1


def add_one(x):
    """``x + 1`` for a contiguous float32 tensor of any shape.  On a CUDA
    device it launches ``csrc/probe_add_one.cu`` and counts the launch in
    ``add_one.launches``."""
    if route(x) == 'plain':
        return add_one_reference(x)
    if x.dtype != torch.float32:
        raise ValueError('add_one takes float32, got {}'.format(x.dtype))
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    out = torch.empty_like(x)
    if not x.numel():
        return out
    _ADD_ONE.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel())
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
