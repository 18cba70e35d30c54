"""Action-conditioned conv-LSTM CDNA/SNA video predictor (PyTorch).

Counterpart of ``visual_foresight_tpu/models/cdna.py`` for the serving
configurations: the space-to-depth backbone (``std_factor`` > 0), CDNA
kernels with SNA first-frame compositing, and the optional per-rollout
latent (``latent_dim`` > 0) that joins the state and action at the
bottleneck.  The time loop is a Python loop; ``encode_context`` consumes the
context frames (with a zero latent), ``rollout_from`` rolls the plan
autoregressively, and ``forward`` is the teacher-forced pass over a whole
trajectory.

The CDNA/SNA tail of every step goes through
``ops.cdna_tail.fused_warp_composite``: the hand-written CUDA kernel on the
card, its plain version on the CPU.  Everything else in the step is stock
PyTorch.

Carries are tuples ``(lstm_states, prev_img, prev_distrib, prev_state,
first_image, first_distrib, latent)``; ``latent`` is ``None`` for a model
without one.  All image-like tensors are NHWC.
"""

import torch
import torch.nn as nn

from visual_foresight_torch.models.layers import (ConvLSTMCell, LayerNorm,
                                                  conv_nhwc)
from visual_foresight_torch.ops.cdna_tail import fused_warp_composite
from visual_foresight_torch.ops.cdna_warp import normalize_kernels
from visual_foresight_torch.ops.layout import depth_to_space, space_to_depth


def broadcast_carry(carry, batch):
    """Broadcast a batch-1 carry to ``batch`` samples (contiguous copies,
    as the tail kernel takes contiguous tensors)."""
    if isinstance(carry, tuple):
        return tuple(broadcast_carry(t, batch) for t in carry)
    if carry is None:       # the latent slot of a model without one
        return None
    return carry.expand((batch,) + carry.shape[1:]).contiguous()


class CDNAStep(nn.Module):
    """One prediction step on the space-to-depth backbone.

    ``forward(carry, x, plan_mode)``: in plan mode ``x`` is the (B, adim)
    action; otherwise it is ``(action, gt_image, gt_distrib, gt_state,
    use_gt)`` and the step input is chosen per sample by ``use_gt``
    (teacher forcing).
    """

    def __init__(self, img_dims, num_masks=10, kernel_size=5, sna=True,
                 num_distribs=0, sdim=3, adim=3, dtype=torch.float32,
                 enc_features=(32, 64, 128), lstm_kernel=5,
                 separable_lstm=False, std_factor=4, renorm_distribs=True,
                 mask_softmax='lowres', latent_dim=0):
        super().__init__()
        if not std_factor:
            raise NotImplementedError('only the space-to-depth backbone '
                                      '(std_factor > 0) is ported')
        if mask_softmax not in ('fullres', 'lowres'):
            raise ValueError('mask_softmax must be fullres or lowres')
        h, w = img_dims
        r = std_factor
        if h % (2 * r) or w % (2 * r):
            raise ValueError('image dims must divide 2 * std_factor')
        self.num_masks, self.kernel_size = num_masks, kernel_size
        self.sna, self.latent_dim = sna, latent_dim
        self.num_distribs, self.dtype, self.r = num_distribs, dtype, r
        self.renorm_distribs, self.mask_softmax = renorm_distribs, mask_softmax
        f1, f2 = enc_features[0], enc_features[1]
        nc = num_masks + (2 if sna else 1)
        lk = (lstm_kernel, lstm_kernel)
        lstm = lambda cin, feat: ConvLSTMCell(
            cin, feat, lk, separable=separable_lstm, external_x=True,
            dtype=dtype)
        self.enc0 = nn.Conv2d(3, 4 * f1, r, stride=r, dtype=dtype)  # RGB
        self.lstm1 = lstm(4 * f1, f1)
        self.ln1 = LayerNorm(f1)
        self.enc1 = nn.Conv2d(f1, f2, 3, stride=2, dtype=dtype)
        self.enc3 = nn.Linear(f2, 4 * f2, dtype=dtype)
        # the latent conditions the bottleneck only; state_head sees
        # state and action alone
        self.cond_proj = nn.Linear(sdim + adim + latent_dim, 4 * f2,
                                   dtype=dtype)
        self.lstm3 = lstm(4 * f2, f2)
        self.ln3 = LayerNorm(f2)
        self.dec1 = nn.Linear(f2, 4 * f1, dtype=dtype)
        self.dec1_gates = nn.Linear(f1, 4 * f1, dtype=dtype)
        self.skip1 = nn.Linear(f1, 4 * f1, dtype=dtype)
        self.lstm4 = lstm(4 * f1, f1)
        self.ln4 = LayerNorm(f1)
        self.mask_head = nn.Linear(f1, r * r * nc, dtype=dtype)
        # the heads run in f32, as flax's default-dtype Dense layers do
        self.cdna_head = nn.Linear((h // (2 * r)) * (w // (2 * r)) * f2,
                                   num_masks * kernel_size ** 2)
        self.state_head = nn.Linear(sdim + adim, sdim)

    def _backbone_std(self, lstm_states, prev_img, cond):
        """Returns (new_lstm_states, h3, masks, mask_block).  With the
        full-resolution softmax the masks are (B, H, W, nc) and
        ``mask_block`` is 0; with the low-resolution one they stay blocked,
        (B, H/r, W/r, r*r*nc) with ``mask_block`` = r, as the tail reads
        them in either layout."""
        r, dt = self.r, self.dtype
        s1, s3, s4 = lstm_states
        xg = conv_nhwc(prev_img.to(dt), self.enc0)                    # H/r
        s1, h1 = self.lstm1(s1, xg)
        h1 = self.ln1(h1)
        enc1 = conv_nhwc(h1, self.enc1, 'SAME')                       # H/2r
        enc3 = self.enc3(enc1) + self.cond_proj(cond.to(dt))[:, None, None, :]
        s3, h3 = self.lstm3(s3, enc3)
        h3 = self.ln3(h3)
        up = depth_to_space(self.dec1(h3), 2)                          # H/r
        gate_in = self.dec1_gates(up) + self.skip1(h1)
        s4, h4 = self.lstm4(s4, gate_in)
        h4 = self.ln4(h4)
        ml = self.mask_head(h4)
        if self.mask_softmax == 'fullres':
            masks = torch.softmax(depth_to_space(ml, r), dim=-1).to(dt)
            return (s1, s3, s4), h3, masks, 0
        b, hm, wm = ml.shape[:3]
        masks = torch.softmax(ml.reshape(b, hm, wm, r * r, -1), dim=-1).to(dt)
        return (s1, s3, s4), h3, masks.reshape(b, hm, wm, -1), r

    def forward(self, carry, x, plan_mode=True):
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
        # the f32 latent joins first; cond_proj then casts the whole vector
        cond = sa if latent is None else torch.cat([sa, latent], dim=-1)
        lstm_states, h3, masks, mask_block = self._backbone_std(
            lstm_states, prev_img, cond)

        b, k, dt = prev_img.shape[0], self.kernel_size, self.dtype
        raw = self.cdna_head(h3.float().reshape(b, -1))   # NHWC flatten
        kernels = normalize_kernels(raw.reshape(b, k, k, self.num_masks))
        prev_c = prev_img.to(dt).contiguous()
        if self.num_distribs:
            pd = prev_distrib.to(dt).contiguous()
            fd = first_distrib.to(dt).contiguous()
        else:
            pd = fd = prev_c.new_zeros(prev_c.shape[:3] + (0,))
        gen_image, gd = fused_warp_composite(
            prev_c, first_image.to(dt).contiguous(), pd, fd,
            kernels.to(dt).contiguous(), masks.contiguous(), sna=self.sna,
            mask_block=mask_block)
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


class CDNAPredictor(nn.Module):
    """Context encoding, plan-mode rollout and the teacher-forced forward
    around one :class:`CDNAStep` (parameters live under ``step.``, as flax's
    scanned step does)."""

    def __init__(self, img_dims, n_context=2, num_masks=10, kernel_size=5,
                 sna=True, num_distribs=0, sdim=3, adim=3,
                 dtype=torch.float32, enc_features=(32, 64, 128),
                 lstm_kernel=5, separable_lstm=False, std_factor=4,
                 renorm_distribs=True, mask_softmax='lowres', latent_dim=0):
        super().__init__()
        self.n_context, self.num_distribs = n_context, num_distribs
        self.sdim, self.dtype, self.latent_dim = sdim, dtype, latent_dim
        self.enc_features = tuple(enc_features)
        self.std_factor = std_factor
        self.step = CDNAStep(
            tuple(img_dims), num_masks=num_masks, kernel_size=kernel_size,
            sna=sna, num_distribs=num_distribs, sdim=sdim, adim=adim,
            dtype=dtype, enc_features=enc_features, lstm_kernel=lstm_kernel,
            separable_lstm=separable_lstm, std_factor=std_factor,
            renorm_distribs=renorm_distribs, mask_softmax=mask_softmax,
            latent_dim=latent_dim)

    def _initial_lstm_states(self, b, h, w, device):
        r = self.std_factor
        f1, f2 = self.enc_features[0], self.enc_features[1]
        init = lambda hh, ww, f: ConvLSTMCell.initial_state(
            b, hh, ww, f, self.dtype, device)
        return (init(h // r, w // r, f1), init(h // (2 * r), w // (2 * r), f2),
                init(h // r, w // r, f1))

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
        for t in range(n_pre):
            gt_d = distribs[:, t].to(dt) if self.num_distribs else \
                torch.zeros((b, 0), dtype=dt, device=dev)
            x = (actions[:, t].float(), images[:, t].to(dt), gt_d,
                 states[:, t].float(), ones)
            carry, _ = self.step(carry, x, plan_mode=False)
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
        imgs, dists, sts = [], [], []
        actions = actions.float()
        for t in range(actions.shape[1]):
            carry, (gi, gd, gs) = self.step(carry, actions[:, t])
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
        actions = actions.float()
        imgs, dists, sts = [], [], []
        for t in range(T):
            x = (actions[:, t], gt_images[:, t], gt_distribs[:, t],
                 gt_states[:, t], gt_mask[:, t])
            carry, (gi, gd, gs) = self.step(carry, x, plan_mode=False)
            imgs.append(gi)
            dists.append(gd)
            sts.append(gs)
        result = {'gen_images': torch.stack(imgs, dim=1).float(),
                  'gen_states': torch.stack(sts, dim=1).float()}
        if self.num_distribs:
            result['gen_distribs'] = torch.stack(dists, dim=1).float()
        return result
