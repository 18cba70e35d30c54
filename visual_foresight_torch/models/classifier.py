"""Planning-cost scoring models (PyTorch): the success classifier and the
NCE embedding.

Counterpart of ``visual_foresight_tpu/models/classifier.py``: small conv
networks that score predicted frames inside the device replan.  Tensors are
NHWC; submodule names follow the flax parameter names, so
``models/convert.py`` maps a flax tree one to one.  The activations are
flax's ``nn.gelu``, the tanh approximation (PyTorch's default, the exact erf
form, differs from it by up to 5e-4).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from visual_foresight_torch.models.layers import conv_nhwc

FEATURES = (32, 64, 128, 256)


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate='tanh')


class ConvEncoder(nn.Module):
    """Shared conv trunk: stride-2 3x3 'SAME' conv blocks + a global mean
    pool in f32.

    :param in_features: channels of the input frames
    """

    def __init__(self, in_features, features=FEATURES, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = (in_features,) + tuple(features)
        for i, f in enumerate(features):
            setattr(self, 'conv{}'.format(i),
                    nn.Conv2d(chans[i], f, 3, stride=2, dtype=dtype))
        self.n_layers = len(features)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = gelu(conv_nhwc(x, getattr(self, 'conv{}'.format(i)), 'SAME'))
        return x.float().mean(dim=(1, 2))          # (B, C)


class SuccessClassifier(nn.Module):
    """p(success | frame, goal frame) as one logit; with
    ``goal_conditioned`` False it reads the frame alone."""

    def __init__(self, features=FEATURES, dtype=torch.float32,
                 goal_conditioned=True):
        super().__init__()
        self.goal_conditioned = goal_conditioned
        self.enc = ConvEncoder(6 if goal_conditioned else 3, features, dtype)
        self.fc1 = nn.Linear(features[-1], 128)
        self.logit = nn.Linear(128, 1)

    def forward(self, frame, goal=None):
        if (goal is not None) != self.goal_conditioned:
            raise ValueError('this classifier was built {} a goal'.format(
                'with' if self.goal_conditioned else 'without'))
        x = frame if goal is None else torch.cat([frame, goal], dim=-1)
        h = gelu(self.fc1(self.enc(x)))
        return self.logit(h)[..., 0]                # (B,)


class NCEEmbedding(nn.Module):
    """Contrastive embedding, L2-normalised; the planning cost is the
    negated dot product with the goal's embedding."""

    def __init__(self, features=FEATURES, embed_dim=128,
                 dtype=torch.float32):
        super().__init__()
        self.enc = ConvEncoder(3, features, dtype)
        self.proj = nn.Linear(features[-1], embed_dim)

    def forward(self, frame):
        z = self.proj(self.enc(frame))
        return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                               min=1e-8)

    @staticmethod
    def score(emb_a, emb_b):
        """Similarity in [-1, 1]; the planning cost is its negative."""
        return (emb_a * emb_b).sum(dim=-1)
