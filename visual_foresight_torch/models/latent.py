"""SV2P-style inference network for the stochastic video predictor
(PyTorch).

Counterpart of ``visual_foresight_tpu/models/latent.py``: the posterior
encoder ``q(z | x_{0:T})`` over a whole trajectory that a stochastic
(``--stochastic``) training run conditions the rollout on, the KL to the
standard normal prior, and the reparameterized sample.  It is a
training-only module: serving checkpoints (``view0``) hold the generative
model alone, and the posterior's parameters live beside them under
``posterior/``.  Submodule names follow the flax parameter names, so
``models/convert.py`` maps a flax tree one to one.
"""

import torch
import torch.nn as nn

from visual_foresight_torch.models.layers import LayerNorm, conv_nhwc


class PosteriorEncoder(nn.Module):
    """q(z | x_{0:T}): a conv tower over frame pairs -> (mu, log_var).

    Frames t and t+1 are stacked channel-wise (a one-frame sequence pairs
    the frame with itself), then three stride-2 SAME 3x3 convolutions, each
    followed by a LayerNorm and a ReLU, run in the compute ``dtype``; the
    result is mean-pooled over space and time and the f32 ``mu`` and
    ``log_var`` heads read it; ``log_var`` is clipped to [-10, 10].
    """

    def __init__(self, latent_dim, features=(32, 64, 128),
                 dtype=torch.float32, channels=3):
        super().__init__()
        self.latent_dim, self.features, self.dtype = latent_dim, \
            tuple(features), dtype
        cin = 2 * channels
        for i, f in enumerate(self.features):
            setattr(self, 'conv{}'.format(i),
                    nn.Conv2d(cin, f, 3, stride=2, dtype=dtype))
            setattr(self, 'ln{}'.format(i), LayerNorm(f))
            cin = f
        # the heads run in f32, as flax's default-dtype Dense layers do
        self.mu = nn.Linear(cin, latent_dim)
        self.log_var = nn.Linear(cin, latent_dim)

    def forward(self, images):
        """:param images: (B, T, H, W, C) float in [0, 1]
        :return: (mu, log_var), each (B, latent_dim) f32"""
        b, t = images.shape[:2]
        if t > 1:
            pairs = torch.cat([images[:, :-1], images[:, 1:]], dim=-1)
        else:
            pairs = torch.cat([images, images], dim=-1)
        tp = pairs.shape[1]
        x = pairs.reshape((b * tp,) + pairs.shape[2:]).to(self.dtype)
        for i in range(len(self.features)):
            x = conv_nhwc(x, getattr(self, 'conv{}'.format(i)), 'SAME')
            x = torch.relu(getattr(self, 'ln{}'.format(i))(x))
        x = x.mean(dim=(1, 2))                          # spatial pool
        x = x.reshape(b, tp, -1).mean(dim=1).float()    # time pool
        return self.mu(x), torch.clamp(self.log_var(x), -10.0, 10.0)


def kl_to_standard_normal(mu, log_var):
    """Mean over the batch of KL( N(mu, diag exp(log_var)) || N(0, I) ), in
    nats."""
    kl = 0.5 * torch.sum(torch.exp(log_var) + mu.square() - 1.0 - log_var,
                         dim=-1)
    return kl.mean()


def reparameterize(generator, mu, log_var, eps=None):
    """z = mu + sigma * eps, eps ~ N(0, I) drawn from ``generator`` (on
    ``mu``'s device) unless given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    return mu + torch.exp(0.5 * log_var) * eps
