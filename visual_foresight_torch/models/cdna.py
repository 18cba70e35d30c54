"""Action-conditioned conv-LSTM CDNA/DNA/SNA video predictor (PyTorch).

Counterpart of ``visual_foresight_tpu/models/cdna.py``, every architecture
it builds:

- the classic three-scale Finn-CDNA backbone (``std_factor`` 0, the JAX
  package's default): five conv-LSTMs at H/2, H/4, H/8, H/4 and H/2, strided
  convolutions down, flax-style transposed convolutions up, the state,
  action and latent smeared over the bottleneck, the mask softmax in f32 at
  full resolution;
- the space-to-depth backbone (``std_factor`` r > 0), the serving
  flagship's, optionally with ``fuse_decode`` (dec1, ``depth_to_space`` and
  dec1_gates composed into one product at H/2r);
- CDNA kernels or, with ``dna``, a per-pixel kernel field; SNA first-frame
  compositing; the optional per-rollout latent (``latent_dim`` > 0) that
  joins the state and action at the bottleneck.

The time loop is a Python loop; ``encode_context`` consumes the context
frames (with a zero latent), ``rollout_from`` rolls the plan
autoregressively, and ``forward`` is the teacher-forced pass over a whole
trajectory.  Each step of the first two is a ``vf.step`` span under
``torch.profiler`` (``utils/profiling.py::span``).

The warp-and-composite tail of a step runs through a kernel of
``ops.cdna_tail`` (on the card the hand-written CUDA kernel, on the CPU its
plain version): CDNA through ``fused_warp_composite`` (the mask x kernel
contraction folded in), DNA through ``fused_warp_composite_dna`` (the field
made inside the kernel from the DNA head's logits and the masks).
``s2d_tail`` is accepted and changes nothing: the JAX package's option runs
the step in a block layout chosen for the TPU's lanes, and here every step
takes the full-resolution tail kernel.
Each conv-LSTM cell's gate nonlinearities, state update and the LayerNorm on
its output run through ``ConvLSTMCell.forward_norm``: on the card, outside
autograd, one launch of ``ops.conv_lstm_ln``'s kernel.  The classic
backbone's two LayerNorms that follow a convolution, ``ln0`` on ``enc0`` and
``ln6`` on ``dec3``, run through ``conv_nhwc_norm`` and
``ConvTranspose.forward_norm``: there one launch of
``ops.conv_lstm_ln.bias_layer_norm`` adds the convolution's bias, normalises
and, for ``dec3``, crops.  Everything else in the step is stock PyTorch.

Carries are tuples ``(lstm_states, prev_img, prev_distrib, prev_state,
first_image, first_distrib, latent)``; ``latent`` is ``None`` for a model
without one.  All image-like tensors are NHWC.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from visual_foresight_torch.models.layers import (ConvLSTMCell,
                                                  ConvTranspose, LayerNorm,
                                                  conv_nhwc, conv_nhwc_norm)
from visual_foresight_torch.ops.cdna_tail import (fused_warp_composite,
                                                  fused_warp_composite_dna)
from visual_foresight_torch.ops.cdna_warp import normalize_kernels
from visual_foresight_torch.ops.layout import depth_to_space, space_to_depth
from visual_foresight_torch.utils.profiling import STEP, span


def broadcast_carry(carry, batch):
    """Broadcast a batch-1 carry to ``batch`` samples (contiguous copies,
    as the tail kernel takes contiguous tensors)."""
    if isinstance(carry, tuple):
        return tuple(broadcast_carry(t, batch) for t in carry)
    if carry is None:       # the latent slot of a model without one
        return None
    return carry.expand((batch,) + carry.shape[1:]).contiguous()


class CDNAStep(nn.Module):
    """One prediction step.

    ``forward(carry, x, plan_mode, decode)``: in plan mode ``x`` is the
    (B, adim) action; otherwise it is ``(action, gt_image, gt_distrib,
    gt_state, use_gt)`` and the step input is chosen per sample by
    ``use_gt`` (teacher forcing).  ``decode`` is :meth:`compose_decode`'s
    result, required under ``fuse_decode`` and made once per rollout by the
    caller.
    """

    def __init__(self, img_dims, num_masks=10, kernel_size=5, sna=True,
                 dna=False, num_distribs=0, sdim=3, adim=3,
                 dtype=torch.float32, enc_features=(32, 64, 128),
                 lstm_kernel=5, separable_lstm=False, std_factor=0,
                 renorm_distribs=True, mask_softmax='lowres', latent_dim=0,
                 fuse_decode=False):
        super().__init__()
        if mask_softmax not in ('fullres', 'lowres'):
            raise ValueError('mask_softmax must be fullres or lowres')
        h, w = img_dims
        r = std_factor
        scale = 2 * r if r else 8
        if h % scale or w % scale:
            raise ValueError('image dims must divide {}'.format(scale))
        self.num_masks, self.kernel_size = num_masks, kernel_size
        self.sna, self.dna, self.latent_dim = sna, dna, latent_dim
        self.num_distribs, self.dtype, self.r = num_distribs, dtype, r
        self.renorm_distribs, self.mask_softmax = renorm_distribs, mask_softmax
        self.fuse_decode = fuse_decode
        self.f1, self.f2, self.f3 = enc_features
        nc = num_masks + (2 if sna else 1)
        kk = kernel_size ** 2
        cond = sdim + adim + latent_dim
        if r:
            self._build_std(nc, kk, cond, (lstm_kernel, lstm_kernel),
                            separable_lstm)
            h3_size = (h // (2 * r)) * (w // (2 * r)) * self.f2
        else:
            self._build_classic(nc, kk, cond, (lstm_kernel, lstm_kernel),
                                separable_lstm)
            h3_size = (h // 8) * (w // 8) * self.f3
        if not dna:
            # the heads run in f32, as flax's default-dtype Dense layers do
            self.cdna_head = nn.Linear(h3_size, num_masks * kk)
        self.state_head = nn.Linear(sdim + adim, sdim)

    def _build_std(self, nc, kk, cond, lk, separable):
        r, dt, f1, f2 = self.r, self.dtype, self.f1, self.f2
        lstm = lambda feat: ConvLSTMCell(feat, feat, lk, separable=separable,
                                         external_x=True, dtype=dt)
        self.enc0 = nn.Conv2d(3, 4 * f1, r, stride=r, dtype=dt)      # RGB
        self.lstm1 = lstm(f1)
        self.ln1 = LayerNorm(f1)
        self.enc1 = nn.Conv2d(f1, f2, 3, stride=2, dtype=dt)
        self.enc3 = nn.Linear(f2, 4 * f2, dtype=dt)
        # the latent conditions the bottleneck only; state_head sees
        # state and action alone
        self.cond_proj = nn.Linear(cond, 4 * f2, dtype=dt)
        self.lstm3 = lstm(f2)
        self.ln3 = LayerNorm(f2)
        self.dec1 = nn.Linear(f2, 4 * f1, dtype=dt)
        self.dec1_gates = nn.Linear(f1, 4 * f1, dtype=dt)
        self.skip1 = nn.Linear(f1, 4 * f1, dtype=dt)
        self.lstm4 = lstm(f1)
        self.ln4 = LayerNorm(f1)
        self.mask_head = nn.Linear(f1, r * r * nc, dtype=dt)
        if self.dna:
            self.dna_head = nn.Linear(f1, r * r * kk, dtype=dt)

    def _build_classic(self, nc, kk, cond, lk, separable):
        dt, f1, f2, f3 = self.dtype, self.f1, self.f2, self.f3
        lstm = lambda cin, feat: ConvLSTMCell(cin, feat, lk,
                                              separable=separable, dtype=dt)
        conv = lambda cin, feat, k: nn.Conv2d(cin, feat, k, stride=2,
                                              dtype=dt)
        self.enc0 = conv(3, f1, 5)                                     # H/2
        self.ln0 = LayerNorm(f1)
        self.lstm1 = lstm(f1, f1)
        self.ln1 = LayerNorm(f1)
        self.enc1 = conv(f1, f2, 3)                                    # H/4
        self.lstm2 = lstm(f2, f2)
        self.ln2 = LayerNorm(f2)
        self.enc2 = conv(f2, f3, 3)                                    # H/8
        self.enc3 = nn.Linear(f3 + cond, f3, dtype=dt)
        self.lstm3 = lstm(f3, f3)
        self.ln3 = LayerNorm(f3)
        self.dec1 = ConvTranspose(f3, f2, dtype=dt)                    # H/4
        self.lstm4 = lstm(2 * f2, f2)
        self.ln4 = LayerNorm(f2)
        self.dec2 = ConvTranspose(f2, f1, dtype=dt)                    # H/2
        self.lstm5 = lstm(2 * f1, f1)
        self.ln5 = LayerNorm(f1)
        self.dec3 = ConvTranspose(f1, f1, dtype=dt)                    # H
        self.ln6 = LayerNorm(f1)
        self.mask_head = nn.Linear(f1, nc, dtype=dt)
        if self.dna:
            self.dna_head = nn.Linear(f1, kk, dtype=dt)

    def compose_decode(self):
        """``fuse_decode``'s weights: dec1, ``depth_to_space`` by 2 and
        dec1_gates as one (16 f1, f2) product at H/2r (d2s only relocates
        (subpixel, feature) channel blocks, and dec1's bias flows through
        the gate projection).  Depends on the parameters alone."""
        f1, f2, g = self.f1, self.f2, 4 * self.f1
        wd = self.dec1.weight.t().reshape(f2, 4, f1)
        wg = self.dec1_gates.weight.t()
        wc = torch.einsum('msc,co->mso', wd, wg).reshape(f2, 4 * g)
        bc = (self.dec1_gates.bias[None, :] +
              self.dec1.bias.reshape(4, f1) @ wg).reshape(-1)
        return wc.t().contiguous(), bc

    def _backbone_std(self, lstm_states, prev_img, cond, decode):
        """Returns (new_lstm_states, h3, masks, mask_block, dna_logits).
        With the full-resolution softmax the masks are (B, H, W, nc) and
        ``mask_block`` is 0; with the low-resolution one they stay blocked,
        (B, H/r, W/r, r*r*nc) with ``mask_block`` = r, as the tail reads
        them in either layout."""
        r, dt = self.r, self.dtype
        s1, s3, s4 = lstm_states
        xg = conv_nhwc(prev_img.to(dt), self.enc0)                    # H/r
        s1, h1 = self.lstm1.forward_norm(s1, xg, self.ln1)
        enc1 = conv_nhwc(h1, self.enc1, 'SAME')                       # H/2r
        enc3 = self.enc3(enc1) + self.cond_proj(cond.to(dt))[:, None, None, :]
        s3, h3 = self.lstm3.forward_norm(s3, enc3, self.ln3)
        if decode is not None:
            # the wide product's depth_to_space by 2 is read as a strided
            # view by the add, so it is never copied
            z = F.linear(h3, *decode)
            skip = self.skip1(h1)
            b, hh, ww, g = z.shape[:3] + skip.shape[-1:]
            gate_in = (skip.view(b, hh, 2, ww, 2, g) +
                       z.view(b, hh, ww, 2, 2, g).permute(0, 1, 3, 2, 4, 5)
                       ).reshape(b, 2 * hh, 2 * ww, g)
        else:
            up = depth_to_space(self.dec1(h3), 2)                      # H/r
            gate_in = self.dec1_gates(up) + self.skip1(h1)
        s4, h4 = self.lstm4.forward_norm(s4, gate_in, self.ln4)
        dna_logits = depth_to_space(self.dna_head(h4), r) if self.dna \
            else None
        ml = self.mask_head(h4)
        if self.mask_softmax == 'fullres':
            masks = torch.softmax(depth_to_space(ml, r), dim=-1).to(dt)
            return (s1, s3, s4), h3, masks, 0, dna_logits
        b, hm, wm = ml.shape[:3]
        masks = torch.softmax(ml.reshape(b, hm, wm, r * r, -1), dim=-1).to(dt)
        return (s1, s3, s4), h3, masks.reshape(b, hm, wm, -1), r, dna_logits

    def _backbone_classic(self, lstm_states, prev_img, cond):
        """The Finn-CDNA three-scale encoder/decoder.  Returns
        (new_lstm_states, h3, masks, 0, dna_logits); the masks are the f32
        softmax at full resolution."""
        dt = self.dtype
        s1, s2, s3, s4, s5 = lstm_states
        enc0 = conv_nhwc_norm(prev_img.to(dt), self.enc0, self.ln0,
                              'SAME')                                    # H/2
        s1, h1 = self.lstm1.forward_norm(s1, enc0, self.ln1)
        enc1 = conv_nhwc(h1, self.enc1, 'SAME')                          # H/4
        s2, h2 = self.lstm2.forward_norm(s2, enc1, self.ln2)
        enc2 = conv_nhwc(h2, self.enc2, 'SAME')                          # H/8
        smear = cond.to(dt)[:, None, None, :].expand(
            enc2.shape[:3] + cond.shape[-1:])
        enc3 = self.enc3(torch.cat([enc2, smear], dim=-1))
        s3, h3 = self.lstm3.forward_norm(s3, enc3, self.ln3)
        s4, h4 = self.lstm4.forward_norm(
            s4, torch.cat([self.dec1(h3), enc1], dim=-1), self.ln4)
        s5, h5 = self.lstm5.forward_norm(
            s5, torch.cat([self.dec2(h4), enc0], dim=-1), self.ln5)
        dec3 = self.dec3.forward_norm(h5, self.ln6)                      # H
        masks = torch.softmax(self.mask_head(dec3).float(), dim=-1)
        dna_logits = self.dna_head(dec3) if self.dna else None
        return (s1, s2, s3, s4, s5), h3, masks, 0, dna_logits

    def _cdna_kernels(self, h3):
        b, k = h3.shape[0], self.kernel_size
        raw = self.cdna_head(h3.float().reshape(b, -1))    # NHWC flatten
        return normalize_kernels(raw.reshape(b, k, k, self.num_masks))

    def forward(self, carry, x, plan_mode=True, decode=None):
        (lstm_states, prev_img, prev_distrib, prev_state,
         first_image, first_distrib, latent) = carry
        if (latent is None) != (not self.latent_dim):
            raise ValueError('the carry holds {} latent but latent_dim is {}'
                             .format('no' if latent is None else 'a',
                                     self.latent_dim))
        if plan_mode:
            action = x
        else:
            action, gt_image, gt_distrib, gt_state, use_gt = x
            use_img = use_gt[:, None, None, None].to(prev_img.dtype)
            prev_img = use_img * gt_image.to(prev_img.dtype) + \
                (1.0 - use_img) * prev_img
            prev_state = use_gt[:, None] * gt_state + \
                (1.0 - use_gt[:, None]) * prev_state
            if self.num_distribs:
                u = use_img.to(prev_distrib.dtype)
                prev_distrib = u * gt_distrib.to(prev_distrib.dtype) + \
                    (1.0 - u) * prev_distrib

        sa = torch.cat([prev_state, action], dim=-1)
        # the f32 latent joins first; the conditioning casts the whole vector
        cond = sa if latent is None else torch.cat([sa, latent], dim=-1)
        if self.r:
            if self.fuse_decode and decode is None:
                raise ValueError('fuse_decode needs the composed weights: '
                                 'pass decode=compose_decode()')
            lstm_states, h3, masks, mask_block, dna_logits = \
                self._backbone_std(lstm_states, prev_img, cond, decode)
        else:
            lstm_states, h3, masks, mask_block, dna_logits = \
                self._backbone_classic(lstm_states, prev_img, cond)

        dt = self.dtype
        gen_image, gd = self._tail(prev_img, prev_distrib, first_image,
                                   first_distrib, h3, masks, mask_block,
                                   dna_logits)
        gen_distrib = prev_distrib
        if self.num_distribs:
            gen_distrib = gd
            if self.renorm_distribs:
                g32 = gd.float()
                total = g32.sum(dim=(1, 2), keepdim=True)
                gen_distrib = (g32 / torch.clamp(total, min=1e-12)).to(dt)

        gen_state = prev_state + self.state_head(sa.float())
        new_carry = (lstm_states, gen_image, gen_distrib, gen_state,
                     first_image, first_distrib, latent)
        return new_carry, (gen_image, gen_distrib, gen_state)

    def _tail(self, prev_img, prev_distrib, first_image, first_distrib, h3,
              masks, mask_block, dna_logits):
        """Warp + composite at full resolution through a tail kernel; the
        distributions come back unnormalized."""
        dt = self.dtype
        prev_c = prev_img.to(dt).contiguous()
        first_c = first_image.to(dt).contiguous()
        if self.num_distribs:
            pd = prev_distrib.to(dt).contiguous()
            fd = first_distrib.to(dt).contiguous()
        else:
            pd = fd = prev_c.new_zeros(prev_c.shape[:3] + (0,))
        if not self.dna:
            kernels = self._cdna_kernels(h3)
            return fused_warp_composite(
                prev_c, first_c, pd, fd, kernels.to(dt).contiguous(),
                masks.to(dt).contiguous(), sna=self.sna,
                mask_block=mask_block)
        # DNA: the kernel makes the effective-kernel field from the logits
        # and the masks at full resolution
        if mask_block:
            masks = depth_to_space(masks, mask_block)
        return fused_warp_composite_dna(
            prev_c, first_c, pd, fd, dna_logits.contiguous(),
            masks.contiguous(), sna=self.sna)


class CDNAPredictor(nn.Module):
    """Context encoding, plan-mode rollout and the teacher-forced forward
    around one :class:`CDNAStep` (parameters live under ``step.``, as flax's
    scanned step does).  ``s2d_tail`` is taken for the JAX model's
    signature and changes nothing (see the module docstring)."""

    def __init__(self, img_dims, n_context=2, num_masks=10, kernel_size=5,
                 sna=True, dna=False, num_distribs=0, sdim=3, adim=3,
                 dtype=torch.float32, enc_features=(32, 64, 128),
                 lstm_kernel=5, separable_lstm=False, std_factor=0,
                 renorm_distribs=True, mask_softmax='lowres', latent_dim=0,
                 s2d_tail=False, fuse_decode=False):
        super().__init__()
        self.n_context, self.num_distribs = n_context, num_distribs
        self.sdim, self.dtype, self.latent_dim = sdim, dtype, latent_dim
        self.enc_features = tuple(enc_features)
        self.std_factor = std_factor
        self.step = CDNAStep(
            tuple(img_dims), num_masks=num_masks, kernel_size=kernel_size,
            sna=sna, dna=dna, num_distribs=num_distribs, sdim=sdim,
            adim=adim, dtype=dtype, enc_features=enc_features,
            lstm_kernel=lstm_kernel, separable_lstm=separable_lstm,
            std_factor=std_factor, renorm_distribs=renorm_distribs,
            mask_softmax=mask_softmax, latent_dim=latent_dim,
            fuse_decode=fuse_decode)

    def _initial_lstm_states(self, b, h, w, device):
        f1, f2, f3 = self.enc_features
        init = lambda d, f: ConvLSTMCell.initial_state(
            b, h // d, w // d, f, self.dtype, device)
        r = self.std_factor
        if r:
            return (init(r, f1), init(2 * r, f2), init(r, f1))
        return (init(2, f1), init(4, f2), init(8, f3), init(4, f2),
                init(2, f1))

    def _decode(self):
        """``fuse_decode``'s composed weights, made once per rollout."""
        return self.step.compose_decode() if self.step.fuse_decode and \
            self.std_factor else None

    def _initial_carry(self, images, states, distribs, latent):
        """The carry before the first step: zero LSTM states, the first
        frame (and distribution) as both the previous and the SNA frame."""
        b, _, h, w, _ = images.shape
        dt, dev = self.dtype, images.device
        first_image = images[:, 0].to(dt)
        first_distrib = distribs[:, 0].to(dt) if self.num_distribs else \
            torch.zeros((b, h, w, 0), dtype=dt, device=dev)
        return (self._initial_lstm_states(b, h, w, dev), first_image,
                first_distrib, states[:, 0].float(), first_image,
                first_distrib, latent)

    def _draw_latent(self, b, device, generator):
        """One N(0, I) latent per rollout, f32, from ``generator`` (which
        must live on ``device``)."""
        return torch.randn((b, self.latent_dim), generator=generator,
                           device=device)

    def encode_context(self, images, actions, states=None, distribs=None):
        """Consume the context frames; return the post-context carry.  The
        context steps of a latent model are conditioned on a zero latent.

        :param images: (B, n_in, H, W, C) float in [0, 1], n_in >= n_context
        :param actions: (B, >= n_context - 1, adim) executed actions
        :param states: (B, n_in, sdim) or None
        :param distribs: (B, n_in, H, W, P) or None
        """
        b, n_in = images.shape[:2]
        if n_in < self.n_context:
            raise ValueError('need {} context frames, got {}'.format(
                self.n_context, n_in))
        dt, dev = self.dtype, images.device
        n_pre = self.n_context - 1
        if states is None:
            states = torch.zeros((b, n_in, self.sdim), device=dev)
        latent = torch.zeros((b, self.latent_dim), device=dev) \
            if self.latent_dim else None
        carry = self._initial_carry(images, states, distribs, latent)
        if n_pre == 0:
            return carry
        ones = torch.ones((b,), device=dev)
        decode = self._decode()
        for t in range(n_pre):
            gt_d = distribs[:, t].to(dt) if self.num_distribs else \
                torch.zeros((b, 0), dtype=dt, device=dev)
            x = (actions[:, t].float(), images[:, t].to(dt), gt_d,
                 states[:, t].float(), ones)
            with span(STEP):
                carry, _ = self.step(carry, x, plan_mode=False,
                                     decode=decode)
        # the next step consumes the final context frame (teacher-forced)
        lstm_states, _, _, _, fi, fd, lat = carry
        last = self.n_context - 1
        return (lstm_states, images[:, last].to(dt),
                distribs[:, last].to(dt) if self.num_distribs else fd,
                states[:, last].float(), fi, fd, lat)

    def rollout_from(self, carry, actions, generator=None, latent=None):
        """Autoregressive rollout from an :meth:`encode_context` carry.

        :param actions: (B, T_plan, adim); the first entry is the action
            paired with the final context frame
        :param generator: ``torch.Generator`` on the carry's device: draw
            the per-rollout latent from the prior N(0, I)
        :param latent: (B, latent_dim) latent given outright; with neither,
            the rollout keeps the carry's (zero) latent
        :return: dict with 'gen_images' (B, T, H, W, C) f32, 'gen_states'
            (B, T, sdim), 'gen_images_tm' (T, B, H, W, C) in the compute
            dtype and, with distributions, 'gen_distribs' (B, T, H, W, P) f32
        """
        if self.latent_dim:
            prev_img = carry[1]
            if latent is None and generator is not None:
                latent = self._draw_latent(prev_img.shape[0], prev_img.device,
                                           generator)
            if latent is not None:
                carry = carry[:6] + (latent.to(prev_img.device).float(),)
        decode = self._decode()
        imgs, dists, sts = [], [], []
        actions = actions.float()
        for t in range(actions.shape[1]):
            with span(STEP):
                carry, (gi, gd, gs) = self.step(carry, actions[:, t],
                                                decode=decode)
            imgs.append(gi)
            dists.append(gd)
            sts.append(gs)
        imgs_tm = torch.stack(imgs)
        result = {
            'gen_images': imgs_tm.transpose(0, 1).float(),
            'gen_states': torch.stack(sts, dim=1).float(),
            'gen_images_tm': imgs_tm,
        }
        if self.num_distribs:
            result['gen_distribs'] = torch.stack(dists, dim=1).float()
        return result

    def forward(self, images, actions, states=None, distribs=None,
                generator=None, gt_mask=None, latent=None):
        """Teacher-forced pass over ``T = actions.shape[1]`` steps; output
        index t predicts frame t + 1.

        :param images: (B, n_in, H, W, C) float in [0, 1]; ground truth past
            ``n_in`` is zero (and should be masked off)
        :param gt_mask: (T,) or (B, T) float schedule, 1 = the step takes the
            ground-truth frame; default: the first ``n_context`` steps.  The
            first step always takes ground truth
        :param latent: (B, latent_dim), conditioning **every** step, the
            context steps too; else drawn from ``generator``; else zeros
        :return: dict of 'gen_images' (B, T, H, W, C), 'gen_states'
            (B, T, sdim) and, with distributions, 'gen_distribs'
        """
        b, n_in, h, w, _ = images.shape
        T = actions.shape[1]
        dt, dev = self.dtype, images.device
        if states is None:
            states = torch.zeros((b, n_in, self.sdim), device=dev)
        if self.num_distribs and (distribs is None or
                                  distribs.shape[-1] != self.num_distribs):
            raise ValueError('need distributions with {} channels'.format(
                self.num_distribs))

        def pad_time(x):
            if x.shape[1] >= T:
                return x[:, :T]
            zeros = x.new_zeros((b, T - x.shape[1]) + x.shape[2:])
            return torch.cat([x, zeros], dim=1)

        gt_images, gt_states = pad_time(images.to(dt)), \
            pad_time(states.float())
        gt_distribs = pad_time(distribs.to(dt)) if self.num_distribs else \
            torch.zeros((b, T, 0), dtype=dt, device=dev)
        if gt_mask is None:
            gt_mask = (torch.arange(T, device=dev) < self.n_context).float()
        gt_mask = torch.as_tensor(gt_mask, dtype=torch.float32, device=dev)
        gt_mask = gt_mask.expand(b, T).clone()
        gt_mask[:, 0] = 1.0

        if not self.latent_dim:
            latent = None
        elif latent is not None:
            latent = latent.to(dev).float()
        elif generator is None:
            latent = torch.zeros((b, self.latent_dim), device=dev)
        else:
            latent = self._draw_latent(b, dev, generator)

        carry = self._initial_carry(images, states, distribs, latent)
        decode = self._decode()
        actions = actions.float()
        imgs, dists, sts = [], [], []
        for t in range(T):
            x = (actions[:, t], gt_images[:, t], gt_distribs[:, t],
                 gt_states[:, t], gt_mask[:, t])
            carry, (gi, gd, gs) = self.step(carry, x, plan_mode=False,
                                            decode=decode)
            imgs.append(gi)
            dists.append(gd)
            sts.append(gs)
        result = {'gen_images': torch.stack(imgs, dim=1).float(),
                  'gen_states': torch.stack(sts, dim=1).float()}
        if self.num_distribs:
            result['gen_distribs'] = torch.stack(dists, dim=1).float()
        return result
