"""Plain float32 reference of the space-to-depth CDNA/SNA predictor.

Written from the architecture's equations, independently of the program:
the conv-LSTM video predictor of Finn et al. (arXiv:1605.07157) with SNA
first-frame compositing (Ebert et al., arXiv:1710.05268), in the serving
flagship's space-to-depth form that the configuration files describe
(``std_factor`` r > 0).  One step, at batch B, NHWC throughout:

- ``enc0``: an r x r convolution of stride r on the previous frame, whose
  4 f1 outputs are the first LSTM's input gates;
- ``lstm1`` at H/r: gates = input + pointwise(depthwise 3x3(h)), split
  i, g, f, o, forget bias +1; LayerNorm (eps 1e-6);
- ``enc1``: 3x3 convolution of stride 2 ('SAME' as XLA pads it) to f2 at
  H/2r; ``enc3`` and ``cond_proj`` (state, action and latent) make the
  bottleneck LSTM's input gates; ``lstm3`` and LayerNorm give h3;
- ``dec1``, depth-to-space by 2, ``dec1_gates`` plus ``skip1(h1)`` make
  ``lstm4``'s input gates at H/r; LayerNorm gives h4;
- ``mask_head`` on h4 gives r*r*nc logits a cell; depth-to-space by r and a
  softmax over the nc = num_masks + 2 channels give the masks at H x W;
- ``cdna_head`` on the flattened h3 gives num_masks K x K kernels, made
  non-negative (ReLU of x - 1e-12, plus 1e-12) and normalised to sum 1;
- the tail: every kernel warps the previous frame and its pixel
  distributions (a correlation with zero padding), and the masks blend the
  previous frame (mask 0), the first frame (mask 1, SNA) and the warped
  candidates;
- ``state_head`` on (state, action) adds to the state.

Nothing here imports the program.  Three precisions:

- 'f32': float32 throughout, the reference proper;
- 'served': float32 arithmetic, with every tensor that a bf16 serving path
  stores (each convolution's, dense layer's and pointwise step's output,
  the LSTM states, LayerNorm's output, the masks, the normalised kernels,
  the frames and distributions) rounded to the configuration's dtype: the
  size of the rounding error that the configuration's precision itself
  makes on a replan, against which the program's error is measured;
- 'lower': the control, one precision below the program's: the same
  tensors and every convolution's and matrix product's operands rounded to
  float8 e4m3 under a per-tensor scale (the configuration stores and
  multiplies them in bfloat16), and the planner's float32 products
  (``planner.py``) with operands rounded to TF32.
"""

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
KERNEL_FLOOR = 1e-12
FP8_MAX = 448.0


def param_specs(cfg):
    """name -> (shape, role, fan_in, served) of every weight, where role is
    'weight', 'bias', 'ln_weight' or 'ln_bias' and served is 'compute' (the
    configuration's dtype) or 'float32'.  Names follow the program's
    module tree, so the same tensors load into both."""
    r = cfg['std_factor']
    f1, f2, _ = cfg['enc_features']
    h, w = cfg['img_dims']
    k, m = cfg['kernel_size'], cfg['num_masks']
    lk = cfg['lstm_kernel']
    nc = m + (2 if cfg['sna'] else 1)
    cond = cfg['sdim'] + cfg['adim'] + cfg['latent_dim']
    h3_size = (h // (2 * r)) * (w // (2 * r)) * f2
    specs = OrderedDict()

    def dense(name, fan_out, fan_in, served='compute'):
        specs['step.{}.weight'.format(name)] = ((fan_out, fan_in), 'weight',
                                                fan_in, served)
        specs['step.{}.bias'.format(name)] = ((fan_out,), 'bias', fan_in,
                                              served)

    def conv(name, cout, cin, kk, groups=1):
        fan_in = cin // groups * kk * kk
        specs['step.{}.weight'.format(name)] = (
            (cout, cin // groups, kk, kk), 'weight', fan_in, 'compute')
        specs['step.{}.bias'.format(name)] = ((cout,), 'bias', fan_in,
                                              'compute')

    def lstm(name, feat):
        conv(name + '.gates_dw', feat, feat, lk, groups=feat)
        dense(name + '.gates_pw', 4 * feat, feat)

    def norm(name, feat):
        specs['step.{}.weight'.format(name)] = ((feat,), 'ln_weight', feat,
                                                'float32')
        specs['step.{}.bias'.format(name)] = ((feat,), 'ln_bias', feat,
                                              'float32')

    conv('enc0', 4 * f1, 3, r)
    lstm('lstm1', f1)
    norm('ln1', f1)
    conv('enc1', f2, f1, 3)
    dense('enc3', 4 * f2, f2)
    dense('cond_proj', 4 * f2, cond)
    lstm('lstm3', f2)
    norm('ln3', f2)
    dense('dec1', 4 * f1, f2)
    dense('dec1_gates', 4 * f1, f1)
    dense('skip1', 4 * f1, f1)
    lstm('lstm4', f1)
    norm('ln4', f1)
    dense('mask_head', r * r * nc, f1)
    dense('cdna_head', m * k * k, h3_size, served='float32')
    dense('state_head', cfg['sdim'], cfg['sdim'] + cfg['adim'],
          served='float32')
    return specs


def check_supported(cfg):
    """The reference covers the space-to-depth backbone with CDNA kernels."""
    if not cfg['std_factor'] or cfg['dna'] or not cfg['separable_lstm']:
        raise ValueError('the reference covers the space-to-depth CDNA '
                         'backbone with separable LSTM gates only')
    if cfg['mask_softmax'] not in ('lowres', 'fullres'):
        raise ValueError('unknown mask_softmax {}'.format(cfg['mask_softmax']))


def _fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = t.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def tf32(t):
    """``t`` (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _same_pad(size, stride, k):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def depth_to_space(x, r):
    """(B, h, w, r*r*C) -> (B, h*r, w*r, C); channel (i*r + j)*C + c holds
    pixel (r*h + i, r*w + j)."""
    b, hh, ww, ch = x.shape
    c = ch // (r * r)
    x = x.reshape(b, hh, ww, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh * r, ww * r, c)


class Reference:
    """The predictor's step, context encode and rollout in plain PyTorch.

    :param cfg: the configuration (``perfbench/configs/<name>.json``)
    :param weights: name -> tensor, as :func:`param_specs` names them (any
        dtype and device; kept as f32 copies on ``device``)
    :param num_distribs: designated pixels a camera (P)
    :param precision: 'f32', 'served' or 'lower' (see the module's
        docstring)
    """

    def __init__(self, cfg, weights, num_distribs, device, precision='f32'):
        check_supported(cfg)
        if precision not in ('f32', 'served', 'lower'):
            raise ValueError('precision is f32, served or lower')
        specs = param_specs(cfg)
        missing = sorted(set(specs) - set(weights))
        if missing:
            raise ValueError('weights missing: {}'.format(missing))
        self.w = {n: weights[n].detach().to(device, torch.float32)
                  for n in specs}
        self.cfg, self.P, self.device = cfg, num_distribs, device
        self.lower = precision == 'lower'
        dtype = {'bfloat16': torch.bfloat16,
                 'float32': torch.float32}[cfg['dtype']]
        self.q = {'f32': lambda t: t, 'lower': _fp8,
                  'served': lambda t: t.to(dtype).float()}[precision]
        self.r = cfg['std_factor']
        self.f1, self.f2, _ = cfg['enc_features']
        self.K, self.M = cfg['kernel_size'], cfg['num_masks']
        self.nc = self.M + (2 if cfg['sna'] else 1)

    # -- primitives --------------------------------------------------------
    def _op(self, x, w):
        return (_fp8(x), _fp8(w)) if self.lower else (x, w)

    def linear(self, name, x):
        x, w = self._op(x, self.w['step.{}.weight'.format(name)])
        return x @ w.t() + self.w['step.{}.bias'.format(name)]

    def conv(self, name, x, stride=1, same=False, groups=1):
        w = self.w['step.{}.weight'.format(name)]
        if same:
            ph = _same_pad(x.shape[1], stride, w.shape[2])
            pw = _same_pad(x.shape[2], stride, w.shape[3])
            x = F.pad(x, (0, 0) + pw + ph)
        x, w = self._op(x, w)
        out = F.conv2d(x.permute(0, 3, 1, 2), w,
                       self.w['step.{}.bias'.format(name)], stride=stride,
                       groups=groups)
        return out.permute(0, 2, 3, 1)

    def norm(self, name, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * \
            self.w['step.{}.weight'.format(name)] + \
            self.w['step.{}.bias'.format(name)]

    def lstm(self, name, state, x_gates, feat):
        q = self.q
        c, h = state
        gates = q(x_gates + q(self.linear(
            name + '.gates_pw',
            q(self.conv(name + '.gates_dw', h, same=True, groups=feat)))))
        i, g, f, o = torch.split(gates, feat, dim=-1)
        c = q(q(torch.sigmoid(q(f + 1.0)) * c) +
              q(q(torch.sigmoid(i)) * q(torch.tanh(g))))
        h = q(q(torch.sigmoid(o)) * q(torch.tanh(c)))
        return (c, h), h

    # -- the step ----------------------------------------------------------
    def masks(self, h4):
        logits = depth_to_space(self.q(self.linear('mask_head', h4)), self.r)
        return self.q(torch.softmax(logits, dim=-1))     # (B, H, W, nc)

    def kernels(self, h3):
        b = h3.shape[0]
        raw = self.linear('cdna_head', h3.reshape(b, -1))
        raw = raw.reshape(b, self.K, self.K, self.M)
        pos = torch.relu(raw - KERNEL_FLOOR) + KERNEL_FLOOR
        return self.q(pos / pos.sum(dim=(1, 2), keepdim=True))

    def tail(self, prev, first, kernels, masks):
        """CDNA warp of ``prev`` (B, H, W, C+P) by each kernel, blended with
        ``first`` (SNA) by the masks."""
        b, h, w, _ = prev.shape
        k, pad = self.K, self.K // 2
        padded = F.pad(prev, (0, 0, pad, pad, pad, pad))
        # patches[..., i*K + j] holds the pixel (i - pad, j - pad) away
        patches = torch.stack([padded[:, i:i + h, j:j + w]
                               for i in range(k) for j in range(k)], dim=-1)
        warped = torch.einsum('bhwct,btm->bhwcm', patches,
                              kernels.reshape(b, k * k, self.M))
        out = prev * masks[..., 0:1]
        offset = 1
        if self.cfg['sna']:
            out = out + first * masks[..., 1:2]
            offset = 2
        return self.q(out + torch.einsum('bhwcm,bhwm->bhwc', warped,
                                         masks[..., offset:]))

    def step(self, carry, action, latent):
        """One step; ``carry`` = (lstm states, prev frame + distributions
        (B, H, W, C+P), first frame + distributions, state)."""
        (s1, s3, s4), prev, first, state = carry
        f1, f2 = self.f1, self.f2
        sa = torch.cat([state, action], dim=-1)
        cond = sa if latent is None else torch.cat([sa, latent], dim=-1)
        q = self.q
        xg = q(self.conv('enc0', prev[..., :3], stride=self.r))
        s1, h1 = self.lstm('lstm1', s1, xg, f1)
        h1 = q(self.norm('ln1', h1))
        enc1 = q(self.conv('enc1', h1, stride=2, same=True))
        enc3 = q(q(self.linear('enc3', enc1)) +
                 q(self.linear('cond_proj', q(cond)))[:, None, None, :])
        s3, h3 = self.lstm('lstm3', s3, enc3, f2)
        h3 = q(self.norm('ln3', h3))
        up = depth_to_space(q(self.linear('dec1', h3)), 2)
        gate_in = q(q(self.linear('dec1_gates', up)) +
                    q(self.linear('skip1', h1)))
        s4, h4 = self.lstm('lstm4', s4, gate_in, f1)
        h4 = q(self.norm('ln4', h4))
        out = self.tail(prev, first, self.kernels(h3), self.masks(h4))
        if self.cfg['renorm_distribs'] and self.P:
            dist = out[..., 3:]
            total = dist.sum(dim=(1, 2), keepdim=True)
            out = torch.cat([out[..., :3],
                             dist / torch.clamp(total, min=1e-12)], dim=-1)
        new_state = state + self.linear('state_head', sa)
        return ((s1, s3, s4), out, first, new_state)

    # -- context and rollout -----------------------------------------------
    def encode(self, images, distribs, states, actions):
        """Context carry at batch 1.

        :param images: (n_ctx, H, W, 3); distribs (n_ctx, H, W, P); states
            (n_ctx, sdim); actions (n_ctx - 1, adim), all f32
        """
        h, w = images.shape[1:3]
        r, f1, f2 = self.r, self.f1, self.f2
        zeros = lambda d, f: torch.zeros((1, h // d, w // d, f),
                                         device=self.device)
        lstm = ((zeros(r, f1), zeros(r, f1)),
                (zeros(2 * r, f2), zeros(2 * r, f2)),
                (zeros(r, f1), zeros(r, f1)))
        frames = self.q(torch.cat([images, distribs], dim=-1))[:, None]
        first = frames[0]
        latent = torch.zeros((1, self.cfg['latent_dim']),
                             device=self.device) \
            if self.cfg['latent_dim'] else None
        carry = (lstm, first, first, states[0:1])
        n_ctx = images.shape[0]
        for t in range(n_ctx - 1):
            carry = (carry[0], frames[t], first, states[t:t + 1])
            carry = self.step(carry, actions[t:t + 1], latent)
        last = n_ctx - 1
        return (carry[0], frames[last], first, states[last:last + 1])

    def rollout(self, carry1, plans, latents=None):
        """Roll ``plans`` (B, T, adim) from a batch-1 carry.

        :return: (B, T, H, W, P) predicted distributions
        """
        b = plans.shape[0]
        expand = lambda t: t.expand((b,) + t.shape[1:])
        (s1, s3, s4), prev, first, state = carry1
        carry = (tuple(tuple(expand(x) for x in s) for s in (s1, s3, s4)),
                 expand(prev), expand(first), expand(state))
        dists = []
        for t in range(plans.shape[1]):
            carry = self.step(carry, plans[:, t], latents)
            dists.append(carry[1][..., 3:])
        return torch.stack(dists, dim=1)


def expected_distance(distribs, grids, finalweight):
    """Expected distance of each predicted distribution to its goal.

    :param distribs: (B, T, ncam, H, W, P)
    :param grids: (ncam, P, H, W) distance of every pixel to the goal
    :return: (B,) the time-weighted (last step ``finalweight``, others 1)
        mean over steps of the expected distance, averaged over cameras and
        designated pixels
    """
    total = distribs.sum(dim=(3, 4), keepdim=True)
    p = distribs / torch.clamp(total, min=1e-6)
    per_step = (p * grids.permute(0, 2, 3, 1)[None, None]).sum(dim=(3, 4))
    steps = per_step.shape[1]
    weights = torch.ones(steps, device=distribs.device)
    weights[-1] = finalweight
    per_goal = (per_step * weights[None, :, None, None]).sum(dim=1) / \
        weights.sum()
    return per_goal.reshape(per_goal.shape[0], -1).mean(dim=1)


def fan_in_scale(fan_in):
    return 1.0 / math.sqrt(fan_in)
