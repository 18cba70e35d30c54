"""One conv-LSTM cell's gates, state update and the LayerNorm on its output.

``csrc/conv_lstm_ln.cu`` computes, per pixel row, from the gate
pre-activations ``x + r`` (split i, g, f, o) and the cell state ``c``::

    c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')
    y  = LayerNorm(h')

in f32, storing ``c'``, ``h'`` and ``y`` in the inputs' type (f32 or bf16);
the LayerNorm normalises ``h'`` as stored.  No TPU kernel stands behind it:
in the JAX package XLA fuses the chain.

The source's second kernel, :func:`bias_layer_norm`, is the LayerNorm that
stands alone after a convolution (the classic backbone's ``ln0`` and
``ln6``)::

    y = LayerNorm(x + conv_bias)

with the sum rounded to ``x``'s type before the statistics, as the stock
add rounds it, and ``x`` read as a strided view (``dec3``'s crop is never
copied).

Dispatch is by ``dispatch.route``: on a CUDA device a call launches the
kernel or raises (also where autograd would record a graph: neither kernel
has a backward); on the CPU it takes the plain version
(:func:`conv_lstm_ln_reference`, :func:`bias_layer_norm_reference`), the
chain of stock ops that ``models/layers.py`` runs off the kernel.
"""

import ctypes

import torch
import torch.nn.functional as F

from visual_foresight_torch.ops.dispatch import (DTYPES, Entry, no_backward,
                                                 route)

SOURCE = 'conv_lstm_ln.cu'
_MAX_VECTORS = 128          # 16-byte words a row: a power of two up to this
_MAX_ROWS = 2 ** 31 - 1     # bias_layer_norm's rows, indexed in 32 bits


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


def bias_layer_norm_reference(x, conv_bias, weight, bias, eps):
    """Plain version of :func:`bias_layer_norm`: ``x + conv_bias`` in
    ``x``'s type (no add where ``conv_bias`` is None), then
    :func:`layer_norm_reference`."""
    if conv_bias is not None:
        x = x + conv_bias
    return layer_norm_reference(x, weight, bias, eps)


def conv_lstm_ln_reference(x, r, c, weight, bias, eps):
    """Plain version: :func:`lstm_update_reference`, then
    :func:`layer_norm_reference` of ``h'``; returns ``(c', h', y)``."""
    new_c, new_h = lstm_update_reference(x, r, c)
    return new_c, new_h, layer_norm_reference(new_h, weight, bias, eps)


def takes_width(features, dtype):
    """Whether the kernel takes rows of ``features`` values of ``dtype``: a
    power of two of 16-byte words, up to ``_MAX_VECTORS``."""
    if dtype not in DTYPES:
        return False
    per_word = 16 // torch.empty((), dtype=dtype).element_size()
    words = features // per_word
    return features > 0 and features % per_word == 0 and \
        words & (words - 1) == 0 and words <= _MAX_VECTORS


_CELL = Entry(SOURCE, 'conv_lstm_ln_forward',
              [ctypes.c_void_p] * 5 + [ctypes.c_float] +
              [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int])
_NORM = Entry(SOURCE, 'bias_layer_norm_forward',
              [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                       ctypes.c_longlong] +
              [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 +
              [ctypes.c_int, ctypes.c_int])


def _check_tensors(named, ref_name, strided=()):
    """Raise unless each tensor of ``named`` (None entries skipped) lies on
    the device of ``named[ref_name]``, has its type (``weight`` and ``bias``
    f32), is contiguous unless named in ``strided``, and starts on a 16-byte
    boundary."""
    ref = named[ref_name]
    if ref.dtype not in DTYPES:
        raise ValueError('unsupported dtype {}'.format(ref.dtype))
    for name, t in named.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError('{} is on {}, {} on {}'.format(
                name, t.device, ref_name, ref.device))
        want = torch.float32 if name in ('weight', 'bias') else ref.dtype
        if t.dtype != want:
            raise ValueError('{} is {}, expected {}'.format(name, t.dtype,
                                                            want))
        if name not in strided and not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
        if t.data_ptr() % 16:
            raise ValueError('{} must start on a 16-byte boundary'.format(
                name))


def _check(x, r, c, weight, bias):
    """Raise unless the kernel takes these tensors."""
    _check_tensors({'x': x, 'c': c, 'weight': weight, 'bias': bias, 'r': r},
                   'c')
    feat = c.shape[-1]
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
    way = route(c, x, r, weight, bias)
    if way == 'plain':
        return conv_lstm_ln_reference(x, r, c, weight, bias, eps)
    if way == 'graph':
        no_backward('conv_lstm_ln')
    _check(x, r, c, weight, bias)
    outs = [torch.empty_like(c) for _ in range(3)]
    rows = c.numel() // c.shape[-1] if c.numel() else 0
    _CELL.launch(c.device, x.data_ptr(), None if r is None else r.data_ptr(),
                 c.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
                 *(t.data_ptr() for t in outs), rows, c.shape[-1],
                 DTYPES[c.dtype])
    conv_lstm_ln.launches += 1
    return tuple(outs)


conv_lstm_ln.launches = 0


def _check_norm(x, conv_bias, weight, bias):
    """Raise unless the LayerNorm kernel takes these tensors."""
    _check_tensors({'x': x, 'conv_bias': conv_bias, 'weight': weight,
                    'bias': bias}, 'x', strided=('x',))
    if x.dim() != 4:
        raise ValueError('x must have 4 dimensions, not {}'.format(x.dim()))
    feat = x.shape[-1]
    for name, t in (('conv_bias', conv_bias), ('weight', weight),
                    ('bias', bias)):
        if t is not None and tuple(t.shape) != (feat,):
            raise ValueError('{} has shape {}, expected {}'.format(
                name, tuple(t.shape), (feat,)))
    if x.stride(-1) != 1:
        raise ValueError('x must have channel stride 1, not {}'.format(
            x.stride(-1)))
    if any(n > 1 and s * x.element_size() % 16
           for n, s in zip(x.shape[:-1], x.stride()[:-1])):
        raise ValueError('every row of x must start on a 16-byte boundary '
                         '(strides {})'.format(x.stride()))
    if not takes_width(feat, x.dtype):
        raise ValueError('no bias_layer_norm kernel for {} features of {}'
                         .format(feat, x.dtype))
    if x.numel() // feat > _MAX_ROWS:
        raise ValueError('bias_layer_norm takes at most {} rows'.format(
            _MAX_ROWS))


def bias_layer_norm(x, conv_bias, weight, bias, eps):
    """LayerNorm over the last axis of ``x + conv_bias`` (``conv_bias`` may
    be None) in one pass; returns a new contiguous tensor shaped like
    ``x``.

    Same contract as :func:`bias_layer_norm_reference`.  On a CUDA device
    ``x`` is a 4-D view with channel stride 1, its start and every row on
    a 16-byte boundary, f32 or bf16 with ``takes_width``
    features; ``conv_bias`` is of ``x``'s type, ``weight`` and ``bias`` f32,
    each (F,), contiguous and 16-byte aligned; none may need a gradient.  It
    launches ``csrc/conv_lstm_ln.cu``'s second kernel and counts the launch
    in ``bias_layer_norm.launches``.
    """
    way = route(x, conv_bias, weight, bias)
    if way == 'plain':
        return bias_layer_norm_reference(x, conv_bias, weight, bias, eps)
    if way == 'graph':
        no_backward('bias_layer_norm')
    _check_norm(x, conv_bias, weight, bias)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _NORM.launch(
        x.device, x.data_ptr(),
        None if conv_bias is None else conv_bias.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), eps, out.data_ptr(),
        *x.shape[:3], *x.stride()[:3], x.shape[-1], DTYPES[x.dtype])
    bias_layer_norm.launches += 1
    return out


bias_layer_norm.launches = 0
