"""Goal-distance network (GDN, PyTorch): learned image registration by a
dense flow field.

Counterpart of ``visual_foresight_tpu/models/gdn.py``: a small conv U-net
predicts, for every output pixel, the (row, col) point of the current image
to sample, and bilinear sampling makes the warped image.  It runs once per
camera and reference image a replan, at batch 1, in plain PyTorch (the JAX
package runs it outside any Pallas kernel too).  Tensors are NHWC;
submodule names follow the flax parameter names.
"""

import torch
import torch.nn as nn

from visual_foresight_torch.models.classifier import gelu
from visual_foresight_torch.models.layers import ConvTranspose, conv_nhwc

FEATURES = (32, 64, 128)


def bilinear_sample(image, coords):
    """Sample ``image`` (B, H, W, C) at continuous ``coords`` (B, H, W, 2),
    given as (row, col); the four corners are blended in JAX's order and a
    corner outside the image reads zero."""
    b, h, w, _ = image.shape
    rows, cols = coords[..., 0], coords[..., 1]
    r0, c0 = torch.floor(rows), torch.floor(cols)
    dr, dc = (rows - r0)[..., None], (cols - c0)[..., None]
    batch = torch.arange(b, device=image.device)[:, None, None]

    def gather(ri, ci):
        valid = (ri >= 0) & (ri <= h - 1) & (ci >= 0) & (ci <= w - 1)
        vals = image[batch, ri.clamp(0, h - 1).long(),
                     ci.clamp(0, w - 1).long()]
        return vals * valid[..., None].to(vals.dtype)

    top = gather(r0, c0) * (1 - dc) + gather(r0, c0 + 1) * dc
    bot = gather(r0 + 1, c0) * (1 - dc) + gather(r0 + 1, c0 + 1) * dc
    return top * (1 - dr) + bot * dr


class GoalDistanceNet(nn.Module):
    """U-net flow predictor: (current I0, reference I1) -> warp points such
    that I0 sampled at them reconstructs I1.  The flow head runs in f32 and
    is scaled by ``flow_scale``."""

    def __init__(self, features=FEATURES, flow_scale=10.0,
                 dtype=torch.float32):
        super().__init__()
        self.features, self.flow_scale, self.dtype = tuple(features), \
            flow_scale, dtype
        chans = 6
        for i, f in enumerate(self.features):
            setattr(self, 'down{}'.format(i),
                    nn.Conv2d(chans, f, 3, stride=2, dtype=dtype))
            chans = f
        n = len(self.features)
        for i, f in enumerate(reversed(self.features[:-1])):
            setattr(self, 'up{}'.format(i), ConvTranspose(chans, f, dtype))
            chans = f + self.features[n - 2 - i]
        self.up_final = ConvTranspose(chans, 16, dtype)
        self.flow_head = nn.Conv2d(16, 2, 3)

    def forward(self, current, reference):
        """
        :param current: (B, H, W, 3) float [0, 1], the image to warp from
        :param reference: (B, H, W, 3), the image to match
        :return: (warped, flow, warp_pts); warp_pts (B, H, W, 2) holds the
            (row, col) source point of every output pixel
        """
        b, h, w, _ = current.shape
        x = torch.cat([current, reference], dim=-1).to(self.dtype)
        skips = []
        n = len(self.features)
        for i in range(n):
            x = gelu(conv_nhwc(x, getattr(self, 'down{}'.format(i)), 'SAME'))
            skips.append(x)
        for i in range(n - 1):
            x = gelu(getattr(self, 'up{}'.format(i))(x))
            x = torch.cat([x, skips[n - 2 - i]], dim=-1)
        x = gelu(self.up_final(x))
        flow = conv_nhwc(x.float(), self.flow_head, 'SAME') * self.flow_scale
        rr = torch.arange(h, dtype=torch.float32, device=current.device)
        cc = torch.arange(w, dtype=torch.float32, device=current.device)
        warp_pts = torch.stack([rr[None, :, None] + flow[..., 0],
                                cc[None, None, :] + flow[..., 1]], dim=-1)
        warped = bilinear_sample(current.float(), warp_pts)
        return warped, flow, warp_pts
