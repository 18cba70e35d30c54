"""Inverse dynamics model (PyTorch): (current frame, goal frame, context
frames) -> an action plan.

Counterpart of ``visual_foresight_tpu/models/inverse.py``: one conv trunk
over the frames stacked on channels, a global mean pool and a dense head
that emits the whole ``plan_T`` x ``adim`` plan in one forward pass.
Tensors are NHWC; submodule names follow the flax parameter names.
"""

import torch
import torch.nn as nn

from visual_foresight_torch.models.classifier import gelu
from visual_foresight_torch.models.layers import conv_nhwc

FEATURES = (32, 64, 128)


class InverseNet(nn.Module):
    """Conv trunk over (current, goal, context...) stacked on channels ->
    global mean pool -> dense action-sequence head.

    :param num_context: context frames a call takes (the input has
        3 * (2 + num_context) channels)
    """

    def __init__(self, adim, plan_T, num_context=2):
        super().__init__()
        self.adim, self.plan_T = adim, plan_T
        chans = (3 * (2 + num_context),) + FEATURES
        for i, f in enumerate(FEATURES):
            setattr(self, 'c{}'.format(i),
                    nn.Conv2d(chans[i], f, 3, stride=2))
        self.fc1 = nn.Linear(FEATURES[-1], 256)
        self.head = nn.Linear(256, plan_T * adim)

    def forward(self, current, goal, context_frames):
        """
        :param current: (B, H, W, 3) float [0, 1]
        :param goal: (B, H, W, 3)
        :param context_frames: (B, num_context, H, W, 3)
        :return: (B, plan_T, adim)
        """
        x = torch.cat([current, goal] + [context_frames[:, i] for i in
                                         range(context_frames.shape[1])],
                      dim=-1)
        for i in range(len(FEATURES)):
            x = gelu(conv_nhwc(x, getattr(self, 'c{}'.format(i)), 'SAME'))
        h = gelu(self.fc1(x.mean(dim=(1, 2))))
        return self.head(h).reshape(-1, self.plan_T, self.adim)
