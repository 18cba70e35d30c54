"""One conv-LSTM cell's gates, state update and the LayerNorm on its output.

``csrc/conv_lstm_ln.cu`` computes, per pixel row, from the gate
pre-activations ``x + r`` (split i, g, f, o) and the cell state ``c``::

    c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')
    y  = LayerNorm(h')

in f32, storing ``c'``, ``h'`` and ``y`` in the inputs' type (f32 or bf16);
the LayerNorm normalises ``h'`` as stored.  No TPU kernel stands behind it:
in the JAX package XLA fuses the chain.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
or raises; a CPU tensor takes :func:`conv_lstm_ln_reference`, the chain of
stock ops that ``models/layers.py`` runs off the kernel.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from visual_foresight_torch.ops import _build

SOURCE = 'conv_lstm_ln.cu'
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS = 128          # 16-byte words a row: a power of two up to this


def lstm_update_reference(x, r, c):
    """The cell's state update: ``(c', h')`` from the gate pre-activations
    ``x`` (plus ``r`` unless it is None), each (..., 4F), and ``c`` (..., F),
    as stock ops in the inputs' type."""
    gates = x if r is None else x + r
    i, g, f, o = torch.split(gates, c.shape[-1], dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return new_c, new_h


def layer_norm_reference(h, weight, bias, eps):
    """LayerNorm over the last axis, statistics and affine map in f32, the
    result in ``h``'s type."""
    y = F.layer_norm(h.float(), (h.shape[-1],), weight.float(), bias.float(),
                     eps=eps)
    return y.to(h.dtype)


def conv_lstm_ln_reference(x, r, c, weight, bias, eps):
    """Plain version: :func:`lstm_update_reference`, then
    :func:`layer_norm_reference` of ``h'``; returns ``(c', h', y)``."""
    new_c, new_h = lstm_update_reference(x, r, c)
    return new_c, new_h, layer_norm_reference(new_h, weight, bias, eps)


def takes_width(features, dtype):
    """Whether the kernel takes rows of ``features`` values of ``dtype``: a
    power of two of 16-byte words, up to ``_MAX_VECTORS``."""
    if dtype not in _DTYPES:
        return False
    per_word = 16 // torch.empty((), dtype=dtype).element_size()
    words = features // per_word
    return features > 0 and features % per_word == 0 and \
        words & (words - 1) == 0 and words <= _MAX_VECTORS


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its ctypes signature."""
    fn = _build.load(SOURCE).conv_lstm_ln_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, r, c, weight, bias):
    """Raise unless the kernel takes these tensors."""
    if c.dtype not in _DTYPES:
        raise ValueError('unsupported dtype {}'.format(c.dtype))
    feat = c.shape[-1]
    named = {'x': x, 'c': c, 'weight': weight, 'bias': bias}
    if r is not None:
        named['r'] = r
    for name, t in named.items():
        if t.device != c.device:
            raise ValueError('{} is on {}, c on {}'.format(name, t.device,
                                                           c.device))
        want = torch.float32 if name in ('weight', 'bias') else c.dtype
        if t.dtype != want:
            raise ValueError('{} is {}, expected {}'.format(name, t.dtype,
                                                            want))
        if not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
        if t.data_ptr() % 16:
            raise ValueError('{} must start on a 16-byte boundary'.format(
                name))
    gate_shape = tuple(c.shape[:-1]) + (4 * feat,)
    for name, t, shape in (('x', x, gate_shape), ('r', r, gate_shape),
                           ('weight', weight, (feat,)),
                           ('bias', bias, (feat,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError('{} has shape {}, expected {}'.format(
                name, tuple(t.shape), shape))
    if not takes_width(feat, c.dtype):
        raise ValueError('no conv_lstm_ln kernel for {} features of {}'
                         .format(feat, c.dtype))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in named.values()):
        raise RuntimeError(
            'conv_lstm_ln has no backward kernel: call it under '
            'torch.no_grad() or with inputs that need no gradient')


def conv_lstm_ln(x, r, c, weight, bias, eps):
    """The cell's update and its LayerNorm in one pass; returns new tensors
    ``(c', h', y)``, each shaped like ``c``.

    Same contract as :func:`conv_lstm_ln_reference`.  On a CUDA device every
    tensor must be contiguous and 16-byte aligned, ``x``, ``r`` and ``c``
    of one type (f32 or bf16) with ``takes_width`` features, ``weight`` and
    ``bias`` f32, and none may need a gradient; it launches
    ``csrc/conv_lstm_ln.cu`` and counts the launch in
    ``conv_lstm_ln.launches``.
    """
    if c.device.type == 'cpu':
        return conv_lstm_ln_reference(x, r, c, weight, bias, eps)
    if c.device.type != 'cuda':
        raise ValueError('no conv_lstm_ln kernel for device {}'.format(
            c.device))
    _check(x, r, c, weight, bias)
    fn = _kernel()
    outs = [torch.empty_like(c) for _ in range(3)]
    rows = c.numel() // c.shape[-1] if c.numel() else 0
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if r is None else r.data_ptr(),
                 c.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
                 *(t.data_ptr() for t in outs), rows, c.shape[-1],
                 _DTYPES[c.dtype], stream)
    if err != 0:
        raise RuntimeError('conv_lstm_ln kernel launch failed: cudaError {}'
                           .format(err))
    conv_lstm_ln.launches += 1
    return tuple(outs)


conv_lstm_ln.launches = 0
