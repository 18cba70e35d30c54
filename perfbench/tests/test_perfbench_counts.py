"""The frozen operation and byte counts against hand counts and against
PyTorch's own count of the reference's products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import spec
from perfbench.counts import s2d_cdna
from perfbench.generator import make_weights
from perfbench.tests import tiny


def test_tail_cost_by_hand():
    """One call at a 4 x 6 image, K = 3, M = 2, SNA, P = 1, bf16."""
    cfg = {'img_dims': [4, 6], 'kernel_size': 3, 'num_masks': 2,
           'sna': True, 'dtype': 'bfloat16'}
    b = 5
    # prev, first (3 each), their distributions (1 each), 4 masks, the new
    # frame (3) and distribution (1): 16 values a pixel; 18 kernel values
    elements = b * (4 * 6 * 16 + 9 * 2)
    # in-bounds taps: rows 3*4 - 2 = 10, columns 3*6 - 2 = 16
    macs = b * 10 * 16 * (2 + 4) + b * 4 * 6 * 4 * 2
    assert s2d_cdna.tail_cost(cfg, b, 1) == (2 * elements, 2 * macs)


def test_flagship_tail_bound():
    """The flagship's tail at B = 768 is bytes-bound at 33.9 us."""
    cfg = tiny.load('tiny_config.json')
    cfg.update({'img_dims': [48, 64], 'kernel_size': 5, 'num_masks': 10,
                'dtype': 'bfloat16'})
    nbytes, flops = s2d_cdna.tail_cost(cfg, 768, 1)
    assert nbytes == 768 * (3072 * 24 + 250) * 2
    assert nbytes / 3.35e12 == pytest.approx(33.92e-6, rel=1e-3)
    assert flops / 67e12 < nbytes / 3.35e12


def test_step_flops_match_the_reference_products():
    """Convolutions and dense layers as PyTorch counts them in the
    reference's step, plus the tail by hand."""
    cfg = tiny.load('tiny_config.json')
    arch = spec.arch('xz_flagship')
    weights = make_weights(cfg, 3, torch.device('cpu'), arch)
    ref = arch.Reference(cfg, weights, 1, torch.device('cpu'))
    b = 3
    h, w = cfg['img_dims']
    images = torch.rand(2, h, w, 3)
    distribs = torch.rand(2, h, w, 1)
    carry = ref.encode(images, distribs, torch.zeros(2, cfg['sdim']),
                       torch.zeros(1, cfg['adim']))
    plans = torch.zeros(b, 1, cfg['adim'])
    latents = torch.zeros(b, cfg['latent_dim'])
    counter = FlopCounterMode(display=False)
    with counter:
        ref.rollout(carry, plans, latents)
    counted = counter.get_total_flops()
    # the reference's tail computes every tap, padding included, and its
    # blend of the warped candidates is one more product
    k, m = cfg['kernel_size'], cfg['num_masks']
    full_tail = b * h * w * 4 * (k * k * m + m) * 2
    products = counted - full_tail
    tail = 2 * s2d_cdna.tail_macs(cfg, b, 1)
    assert s2d_cdna.step_flops(cfg, b, 1) == products + tail
