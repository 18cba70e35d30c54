"""Plain float32 reference of the classic three-scale CDNA/SNA predictor.

Written from the architecture's equations, independently of the program:
the conv-LSTM video predictor of Finn et al. (arXiv:1605.07157) with SNA
first-frame compositing (Ebert et al., arXiv:1710.05268), in the form of
the JAX package's default configuration (``std_factor`` 0): five conv-LSTMs
rather than the paper's seven, depthwise-separable gates, 48x64 images.
One step, at batch B, NHWC throughout, every strided convolution 'SAME'
as XLA pads it:

- ``enc0``: 5x5 convolution of stride 2 on the previous frame to f1 at
  H/2, then the LayerNorm ``ln0``;
- each cell (``lstm1`` at H/2, ``lstm2`` at H/4, ``lstm3`` at H/8,
  ``lstm4`` at H/4, ``lstm5`` at H/2): gates = pointwise(depthwise
  KxK([x, h])), split i, g, f, o, forget bias +1; its LayerNorm (eps
  1e-6) gives the cell's output;
- ``enc1``, ``enc2``: 3x3 convolutions of stride 2 to f2 at H/4 and f3 at
  H/8; the state, action and latent, smeared over the H/8 grid and joined
  to ``enc2``, make ``enc3``'s input (a 1x1 convolution to f3);
- ``dec1``, ``dec2``, ``dec3``: flax's transposed convolutions (3x3,
  stride 2, 'SAME'): the input dilated by 2, padded by (2, 1) and
  correlated with the kernel as it is stored, unflipped; ``dec1`` and
  ``dec2`` are joined to ``enc1`` and ``enc0`` (the skips) as the inputs of
  ``lstm4`` and ``lstm5``; ``dec3`` at full resolution, then the LayerNorm
  ``ln6``;
- ``mask_head`` (1x1) on it gives nc = num_masks + 2 logits a pixel, whose
  softmax in float32 gives the masks at H x W;
- ``cdna_head`` on the NHWC flatten of h3 (the output of ``lstm3``'s
  LayerNorm) gives the CDNA kernels, and the tail warps and composites as
  ``reference/model.py`` does it;
- ``state_head`` on (state, action) adds to the state.

Nothing here imports the program.  The three precisions of
``reference/model.py``; 'served' rounds to the configuration's dtype what
the classic serving path stores in it: each convolution's and transposed
convolution's product and then its sum with the bias (the port adds a
convolution's bias to the stored product; on some seeds that second
rounding is most of the step's rounding error), each dense layer's output,
the cell's new state and output as its kernel stores them (c' and h' from
float32 arithmetic, the LayerNorm of h' as stored), ``ln0``'s and
``ln6``'s output, the masks (after the float32 softmax), the normalised
kernels, the frames and distributions.
"""

from collections import OrderedDict

import torch
import torch.nn.functional as F

from perfbench.reference import model


def param_specs(cfg):
    """name -> (shape, role, fan_in, served), as ``reference/model.py``'s
    ``param_specs`` gives them, in the order of the program's module tree
    (the classic step's layers, then ``cdna_head`` and ``state_head``)."""
    f1, f2, f3 = cfg['enc_features']
    h, w = cfg['img_dims']
    k, m = cfg['kernel_size'], cfg['num_masks']
    lk = cfg['lstm_kernel']
    nc = m + (2 if cfg['sna'] else 1)
    cond = cfg['sdim'] + cfg['adim'] + cfg['latent_dim']
    specs = OrderedDict()

    def pair(name, wshape, fan_in, served='compute'):
        specs['step.{}.weight'.format(name)] = (wshape, 'weight', fan_in,
                                                served)
        specs['step.{}.bias'.format(name)] = ((wshape[0],), 'bias', fan_in,
                                              served)

    def conv(name, cout, cin, kk, groups=1):
        pair(name, (cout, cin // groups, kk, kk), cin // groups * kk * kk)

    def dense(name, fan_out, fan_in, served='compute'):
        pair(name, (fan_out, fan_in), fan_in, served)

    def lstm(name, cin, feat):
        conv(name + '.gates_dw', cin + feat, cin + feat, lk,
             groups=cin + feat)
        dense(name + '.gates_pw', 4 * feat, cin + feat)

    def norm(name, feat):
        specs['step.{}.weight'.format(name)] = ((feat,), 'ln_weight', feat,
                                                'float32')
        specs['step.{}.bias'.format(name)] = ((feat,), 'ln_bias', feat,
                                              'float32')

    def deconv(name, cout, cin):
        # (out, in, 3, 3): the flax kernel (3, 3, in, out) in conv layout;
        # fan-in as flax's initialiser counts it from the kernel's shape
        conv(name, cout, cin, 3)

    conv('enc0', f1, 3, 5)
    norm('ln0', f1)
    lstm('lstm1', f1, f1)
    norm('ln1', f1)
    conv('enc1', f2, f1, 3)
    lstm('lstm2', f2, f2)
    norm('ln2', f2)
    conv('enc2', f3, f2, 3)
    dense('enc3', f3, f3 + cond)
    lstm('lstm3', f3, f3)
    norm('ln3', f3)
    deconv('dec1', f2, f3)
    lstm('lstm4', 2 * f2, f2)
    norm('ln4', f2)
    deconv('dec2', f1, f2)
    lstm('lstm5', 2 * f1, f1)
    norm('ln5', f1)
    deconv('dec3', f1, f1)
    norm('ln6', f1)
    dense('mask_head', nc, f1)
    dense('cdna_head', m * k * k, (h // 8) * (w // 8) * f3, served='float32')
    dense('state_head', cfg['sdim'], cfg['sdim'] + cfg['adim'],
          served='float32')
    return specs


def check_supported(cfg):
    """The reference covers the classic backbone with CDNA kernels and
    separable LSTM gates."""
    if cfg['std_factor'] or cfg['dna'] or not cfg['separable_lstm']:
        raise ValueError('the classic reference covers std_factor 0 with '
                         'CDNA kernels and separable LSTM gates only')
    h, w = cfg['img_dims']
    if h % 8 or w % 8:
        raise ValueError('image dims must divide 8')


class Reference(model.Reference):
    """The classic predictor's step, context encode and rollout in plain
    PyTorch, with the interface ``reference/planner.py`` sets out; the
    primitives (``linear``, ``conv``, ``norm``, ``kernels``, ``tail``) are
    ``reference/model.py``'s."""

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
        self.lower, self.exact = precision == 'lower', precision == 'f32'
        dtype = {'bfloat16': torch.bfloat16,
                 'float32': torch.float32}[cfg['dtype']]
        self.q = {'f32': lambda t: t, 'lower': model._fp8,
                  'served': lambda t: t.to(dtype).float()}[precision]
        self.f1, self.f2, self.f3 = cfg['enc_features']
        self.K, self.M = cfg['kernel_size'], cfg['num_masks']
        self.nc = self.M + (2 if cfg['sna'] else 1)

    # -- layers ------------------------------------------------------------
    def conv(self, name, x, stride=1, same=False, groups=1):
        """``reference/model.py``'s convolution; outside 'f32' its product
        is rounded before the bias is added, as the port stores the
        product that cuDNN gives and adds the bias to it in the stored
        type (the caller rounds the sum)."""
        out = super().conv(name, x, stride, same, groups)
        if not self.exact:
            bias = self.w['step.{}.bias'.format(name)]
            out = self.q(out - bias) + bias
        return out

    def deconv(self, name, x):
        """flax ``ConvTranspose`` (3x3, stride 2, 'SAME'): ``x`` dilated by
        2, padded by (2, 1), correlated with the stored kernel."""
        b, h, w, c = x.shape
        dilated = x.new_zeros((b, 2 * h - 1, 2 * w - 1, c))
        dilated[:, ::2, ::2] = x
        return self.conv(name, F.pad(dilated, (0, 0, 2, 1, 2, 1)))

    def cell(self, name, ln, state, x, feat):
        """A cell over ``[x, h]`` and its LayerNorm ``ln``: returns the new
        (c, h) and the normalised output."""
        q = self.q
        c, h = state
        xh = torch.cat([x, h], dim=-1)
        gates = q(self.linear(name + '.gates_pw', q(self.conv(
            name + '.gates_dw', xh, same=True, groups=xh.shape[-1]))))
        i, g, f, o = torch.split(gates, feat, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = q(torch.sigmoid(o) * torch.tanh(c_new))
        return (q(c_new), h_new), q(self.norm(ln, h_new))

    def masks(self, dec3):
        return self.q(torch.softmax(self.q(self.linear('mask_head', dec3)),
                                    dim=-1))

    # -- the step ----------------------------------------------------------
    def step(self, carry, action, latent):
        """One step; ``carry`` = (the five cells' states, prev frame +
        distributions (B, H, W, C+P), first frame + distributions,
        state)."""
        (s1, s2, s3, s4, s5), prev, first, state = carry
        f1, f2, f3 = self.f1, self.f2, self.f3
        q = self.q
        sa = torch.cat([state, action], dim=-1)
        cond = sa if latent is None else torch.cat([sa, latent], dim=-1)
        enc0 = q(self.norm('ln0', q(self.conv('enc0', prev[..., :3],
                                              stride=2, same=True))))
        s1, h1 = self.cell('lstm1', 'ln1', s1, enc0, f1)
        enc1 = q(self.conv('enc1', h1, stride=2, same=True))
        s2, h2 = self.cell('lstm2', 'ln2', s2, enc1, f2)
        enc2 = q(self.conv('enc2', h2, stride=2, same=True))
        smear = q(cond)[:, None, None, :].expand(
            enc2.shape[:3] + cond.shape[-1:])
        enc3 = q(self.linear('enc3', torch.cat([enc2, smear], dim=-1)))
        s3, h3 = self.cell('lstm3', 'ln3', s3, enc3, f3)
        dec1 = q(self.deconv('dec1', h3))
        s4, h4 = self.cell('lstm4', 'ln4', s4,
                           torch.cat([dec1, enc1], dim=-1), f2)
        dec2 = q(self.deconv('dec2', h4))
        s5, h5 = self.cell('lstm5', 'ln5', s5,
                           torch.cat([dec2, enc0], dim=-1), f1)
        dec3 = q(self.norm('ln6', q(self.deconv('dec3', h5))))
        out = self.tail(prev, first, self.kernels(h3), self.masks(dec3))
        if self.cfg['renorm_distribs'] and self.P:
            dist = out[..., 3:]
            total = dist.sum(dim=(1, 2), keepdim=True)
            out = torch.cat([out[..., :3],
                             dist / torch.clamp(total, min=1e-12)], dim=-1)
        new_state = state + self.linear('state_head', sa)
        return ((s1, s2, s3, s4, s5), out, first, new_state)

    # -- context and rollout -----------------------------------------------
    def encode(self, images, distribs, states, actions):
        """Context carry at batch 1 (the arguments as
        ``reference/model.py``'s ``encode`` takes them)."""
        h, w = images.shape[1:3]
        f1, f2, f3 = self.f1, self.f2, self.f3
        zeros = lambda d, f: torch.zeros((1, h // d, w // d, f),
                                         device=self.device)
        lstm = tuple((zeros(d, f), zeros(d, f))
                     for d, f in ((2, f1), (4, f2), (8, f3), (4, f2),
                                  (2, f1)))
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
        """Roll ``plans`` (B, T, adim) from a batch-1 carry; returns (B, T,
        H, W, P) predicted distributions."""
        b = plans.shape[0]
        expand = lambda t: t.expand((b,) + t.shape[1:])
        states, prev, first, state = carry1
        carry = (tuple(tuple(expand(x) for x in s) for s in states),
                 expand(prev), expand(first), expand(state))
        dists = []
        for t in range(plans.shape[1]):
            carry = self.step(carry, plans[:, t], latents)
            dists.append(carry[1][..., 3:])
        return torch.stack(dists, dim=1)
