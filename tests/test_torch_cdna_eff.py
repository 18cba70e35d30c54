"""Port parity: the effective-kernel entry of ``ops/cdna_tail.py``
(``fused_warp_composite_eff``: the per-pixel kernel field and the background
masks given, the contract of the Pallas ``fused_warp_composite_eff``), against
the JAX package.  Inputs come from numpy with a fixed seed.

The Pallas kernels run in interpret mode at P 1 and 2; at P=0 both raise
``ZeroDivisionError`` there, so the frame-only tail is held against the JAX
model's XLA tail (``dna_warp`` plus compositing).

Tolerances: f32 1e-5 (the same arithmetic in another summation order); bf16
2e-2 (both sides round the [0, 1] outputs to bf16, whose ulp is 7.8e-3 near
1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.ops import cdna_warp as jwarp
from visual_foresight_tpu.ops.pallas_cdna import (fused_warp_composite_chw,
                                                  fused_warp_composite_eff)
from visual_foresight_torch.ops import cdna_tail

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, H, W, C = 4, 16, 24, 3
NAMES = ('prev', 'first', 'pd', 'fd', 'eff', 'bg')


def _inputs(seed, p=1, k=5, sna=True):
    """Frames and distributions in [0, 1]; a DNA field (normalized kernels
    weighed by a transform-mask total below 1) and background masks that
    complete it to one."""
    rng = np.random.RandomState(seed)
    nbg = 2 if sna else 1
    logits = rng.randn(B, H, W, nbg + 1).astype(np.float32)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pk = rng.rand(B, H, W, k * k).astype(np.float32)
    return {
        'prev': rng.rand(B, H, W, C).astype(np.float32),
        'first': rng.rand(B, H, W, C).astype(np.float32),
        'pd': rng.rand(B, H, W, p).astype(np.float32),
        'fd': rng.rand(B, H, W, p).astype(np.float32),
        'eff': pk / pk.sum(-1, keepdims=True) * masks[..., nbg:],
        'bg': masks[..., :nbg],
    }


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, 'max abs err {} > {}'.format(err, tol)


@pytest.mark.parametrize('k', [3, 5])
@pytest.mark.parametrize('sna', [True, False])
@pytest.mark.parametrize('p', [1, 2])
def test_eff_plain_version_matches_both_pallas_kernels(p, sna, k):
    d = _inputs(p * 10 + k, p=p, k=k, sna=sna)
    j = [jnp.asarray(d[n]) for n in NAMES]
    want_eff = fused_warp_composite_eff(*j, sna=sna, block_b=2,
                                        interpret=True)
    want_chw = fused_warp_composite_chw(*j, sna=sna, block_b=2,
                                        interpret=True)
    before = cdna_tail.fused_warp_composite_eff.launches
    got = cdna_tail.fused_warp_composite_eff(*(_t(d[n]) for n in NAMES),
                                             sna=sna)
    # a CPU tensor takes the plain version and launches nothing
    assert cdna_tail.fused_warp_composite_eff.launches == before
    for want in (want_eff, want_chw):
        _close(got[0], want[0], F32_TOL)
        _close(got[1], want[1], F32_TOL)


@pytest.mark.parametrize('sna', [True, False])
def test_eff_plain_version_frame_only_matches_xla_tail(sna):
    """P=0, against the JAX model's XLA tail: ``dna_warp`` of the frame plus
    the background compositing (``models/cdna.py`` :497-524)."""
    d = _inputs(2, p=0, sna=sna)
    j = {n: jnp.asarray(d[n]) for n in NAMES}
    want = j['prev'] * j['bg'][..., 0:1]
    if sna:
        want = want + j['first'] * j['bg'][..., 1:2]
    want = want + jwarp.dna_warp(j['prev'], j['eff'])
    img, dist = cdna_tail.fused_warp_composite_eff(
        *(_t(d[n]) for n in NAMES), sna=sna)
    _close(img, want, F32_TOL)
    assert tuple(dist.shape) == (B, H, W, 0)


def test_eff_plain_version_bf16_matches_pallas():
    d = _inputs(3)
    j = [jnp.asarray(d[n], jnp.bfloat16) for n in NAMES]
    want = fused_warp_composite_eff(*j, sna=True, block_b=2, interpret=True)
    got = cdna_tail.fused_warp_composite_eff(
        *(_t(d[n], torch.bfloat16) for n in NAMES), sna=True)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _close(got[0], want[0], BF16_TOL)
    _close(got[1], want[1], BF16_TOL)


def test_eff_entry_checks_and_dispatch():
    """The wrapper's checks, which run before any launch, called directly;
    a device that is neither the CPU nor CUDA raises."""
    d = _inputs(4)
    args = [_t(d[n]) for n in NAMES]
    cdna_tail._check_eff(*args, True)
    cdna_tail._check_eff(*args[:5], args[5][..., :1].contiguous(), False)
    with pytest.raises(ValueError, match='2 with SNA'):
        cdna_tail._check_eff(*args[:5], args[5][..., :1].contiguous(), True)
    with pytest.raises(ValueError, match='K\\*K'):
        cdna_tail._check_eff(*args[:4], args[4][..., :24].contiguous(),
                             args[5], True)
    with pytest.raises(ValueError, match='eff_kernels has shape'):
        cdna_tail._check_eff(*args[:4], args[4][:, :8].contiguous(), args[5],
                             True)
    with pytest.raises(ValueError, match='bfloat16'):
        cdna_tail._check_eff(*args[:4], args[4].to(torch.bfloat16), args[5],
                             True)
    with pytest.raises(ValueError, match='no hand-written kernel'):
        cdna_tail.fused_warp_composite_eff(*(a.to('meta') for a in args))
