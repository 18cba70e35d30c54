"""Building blocks for the video-prediction models (PyTorch).

Counterpart of ``visual_foresight_tpu/models/layers.py``.  Tensors are NHWC
at every public boundary; convolutions run on NCHW views of channels-last
memory, so no layout copy is made.  Submodule names follow the flax
parameter names, so ``models/convert.py`` maps a flax tree one to one.

Where ``ops/dispatch.py``'s ``route`` says ``'kernel'`` (on the card, no
autograd graph recorded), the :class:`LayerNorm` modules run through
``ops/conv_lstm_ln.py``'s kernels: after a conv-LSTM cell inside the cell's
launch (``ConvLSTMCell.forward_norm``), after a convolution with the
convolution's bias folded in (``conv_nhwc_norm``,
``ConvTranspose.forward_norm``), alone otherwise (``LayerNorm.forward``).
Everywhere else they are stock ops.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from visual_foresight_torch.ops.conv_lstm_ln import (bias_layer_norm,
                                                     conv_lstm_ln,
                                                     layer_norm_reference,
                                                     lstm_update_reference)
from visual_foresight_torch.ops.dispatch import route

LN_EPS = 1e-6  # flax's LayerNorm epsilon (torch's default is 1e-5)


def same_pad(in_size, stride, k):
    """XLA 'SAME' padding: output = ceil(in/stride), (low, high) pad."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k - in_size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, conv, padding='VALID', with_bias=True):
    """Apply an ``nn.Conv2d`` to an NHWC tensor with flax ``padding``
    ('SAME' or 'VALID') and return NHWC; without its bias unless
    ``with_bias``."""
    if padding == 'SAME':
        (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
        ph = same_pad(x.shape[1], sh, kh)
        pw = same_pad(x.shape[2], sw, kw)
        x = F.pad(x, (0, 0) + pw + ph)
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight,
                   conv.bias if with_bias else None, stride=conv.stride,
                   groups=conv.groups)
    return out.permute(0, 2, 3, 1)


def conv_nhwc_norm(x, conv, ln, padding='VALID'):
    """``ln(conv_nhwc(x, conv, padding))``.  Where ``route`` says
    ``'kernel'``, the convolution runs without its bias and one launch of
    ``ops/conv_lstm_ln.py``'s ``bias_layer_norm`` adds the bias (rounded as
    the stock add rounds it) and normalises; otherwise the stock ops."""
    if isinstance(ln, LayerNorm) and \
            route(x, conv.weight, conv.bias, ln.weight, ln.bias) == 'kernel':
        return bias_layer_norm(conv_nhwc(x, conv, padding, with_bias=False),
                               conv.bias, ln.weight.float(), ln.bias.float(),
                               LN_EPS)
    return ln(conv_nhwc(x, conv, padding))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (3, 3), strides=(2, 2),
    padding='SAME')`` on NHWC tensors, as the classic decoder has it.

    flax does not flip the kernel (``transpose_kernel=False``) and pads the
    dilated input by (2, 1), which ``F.conv_transpose2d``'s symmetric
    padding cannot express.  So the kernel is flipped spatially, the
    transposed convolution runs unpadded (which pads (2, 2)), and the last
    row and column are cut off.

    The weight is held in conv layout ``(out, in, 3, 3)``, where
    ``params_from_flax`` places the flax HWIO kernel ``(3, 3, in, out)``.
    """

    def __init__(self, in_features, features, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))
        nn.init.kaiming_uniform_(self.weight)

    def _uncropped(self, x, bias):
        """The NHWC product before the crop, (B, 2H + 1, 2W + 1, out)."""
        w = self.weight.flip(2, 3).transpose(0, 1)      # (in, out, 3, 3)
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, bias, stride=2)
        return out.permute(0, 2, 3, 1)

    def forward(self, x):
        return self._uncropped(x, self.bias)[:, :-1, :-1]

    def forward_norm(self, x, ln):
        """``ln(self(x))``.  Where ``route`` says ``'kernel'``, the
        transposed convolution runs without its bias and one launch of
        ``ops/conv_lstm_ln.py``'s ``bias_layer_norm`` adds the bias,
        normalises and crops, reading the uncropped product in place;
        otherwise the stock ops."""
        if isinstance(ln, LayerNorm) and route(
                x, self.weight, self.bias, ln.weight, ln.bias) == 'kernel':
            return bias_layer_norm(self._uncropped(x, None)[:, :-1, :-1],
                                   self.bias, ln.weight.float(),
                                   ln.bias.float(), LN_EPS)
        return ln(self(x))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell; state is (c, h), both (B, H, W, features).

    Gates come from a convolution over concat([x, h]) split four ways in the
    order i, g, f, o, with the forget-gate bias +1 folded in.

    - dense: one KxK conv ``gates`` over concat([x, h]);
    - ``separable``: depthwise KxK ``gates_dw`` + pointwise ``gates_pw``;
    - ``external_x``: x is already the (B, H, W, 4*features) gate
      pre-activation; only h goes through ``gates_dw`` + ``gates_pw``.

    :param in_features: channels of x (unused with ``external_x``)
    """

    def __init__(self, in_features, features, kernel_size=(5, 5),
                 separable=False, external_x=False, dtype=torch.float32):
        super().__init__()
        self.features = features
        self.separable = separable
        self.external_x = external_x
        if kernel_size[0] % 2 == 0 or kernel_size[1] % 2 == 0:
            raise ValueError('SAME gate convs need odd kernel sizes')
        if external_x or separable:
            ch = features if external_x else in_features + features
            self.gates_dw = nn.Conv2d(ch, ch, kernel_size, groups=ch,
                                      dtype=dtype)
            self.gates_pw = nn.Linear(ch, 4 * features, dtype=dtype)
        else:
            self.gates = nn.Conv2d(in_features + features, 4 * features,
                                   kernel_size, dtype=dtype)

    def _gate_addends(self, h, x):
        """The gate pre-activations as ``(x, r)``, summed to give them: r
        is the recurrent product under ``external_x``, else None (one
        tensor holds them all)."""
        if self.external_x:
            return x, self.gates_pw(conv_nhwc(h, self.gates_dw, 'SAME'))
        xh = torch.cat([x, h], dim=-1)
        if self.separable:
            return self.gates_pw(conv_nhwc(xh, self.gates_dw, 'SAME')), None
        return conv_nhwc(xh, self.gates, 'SAME'), None

    def forward(self, state, x):
        c, h = state
        new_c, new_h = lstm_update_reference(*self._gate_addends(h, x), c)
        return (new_c, new_h), new_h

    def forward_norm(self, state, x, ln):
        """The step followed by the :class:`LayerNorm` ``ln``: returns
        ``((c', h'), ln(h'))``.  Where ``route`` says ``'kernel'`` (on the
        card, grad mode off or nothing needing a gradient), the update and
        the norm are one launch of ``ops/conv_lstm_ln.py``'s kernel, which
        raises for a width or type it does not take; otherwise the stock
        ops of :meth:`forward` and ``ln``."""
        c, h = state
        x, r = self._gate_addends(h, x)
        if isinstance(ln, LayerNorm) and \
                route(x, r, c, ln.weight, ln.bias) == 'kernel':
            new_c, new_h, y = conv_lstm_ln(
                x.contiguous(), None if r is None else r.contiguous(),
                c.contiguous(), ln.weight.float(), ln.bias.float(), LN_EPS)
            return (new_c, new_h), y
        new_c, new_h = lstm_update_reference(x, r, c)
        return (new_c, new_h), ln(new_h)

    @staticmethod
    def initial_state(batch, height, width, features, dtype=torch.float32,
                      device=None):
        shape = (batch, height, width, features)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis with flax's epsilon; the
    statistics and the affine map run in f32 and the result is cast back to
    the input dtype.  Where ``route`` says ``'kernel'``, one launch of
    ``ops/conv_lstm_ln.py``'s ``bias_layer_norm`` (which raises for a
    width, type or layout it does not take); otherwise the stock ops."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if route(x, self.weight, self.bias) == 'kernel':
            return bias_layer_norm(x, None, self.weight.float(),
                                   self.bias.float(), LN_EPS)
        return layer_norm_reference(x, self.weight, self.bias, LN_EPS)
