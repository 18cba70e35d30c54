"""Port parity: ``visual_foresight_torch.ops`` (cdna_warp + the plain CDNA
tail) against the JAX package's ``ops/cdna_warp.py`` and the Pallas tail
kernels in interpret mode.  Inputs come from numpy with a fixed seed.

Tolerances: f32 1e-5 (the same arithmetic in another summation order);
bf16 2e-2 (both sides round the [0, 1] outputs to bf16, whose ulp is
7.8e-3 near 1, and JAX rounds its bf16 effective kernels as well)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.ops import cdna_warp as jwarp
from visual_foresight_tpu.ops.pallas_cdna import (fused_warp_composite,
                                                  fused_warp_composite_chw)
from visual_foresight_torch.ops import cdna_warp as twarp
from visual_foresight_torch.ops import cdna_tail
from visual_foresight_torch.ops.layout import depth_to_space, space_to_depth

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, H, W, C, P, K, M = 4, 16, 24, 3, 1, 5, 4


def _inputs(seed=0, p=P, sna=True):
    rng = np.random.RandomState(seed)
    offset = 2 if sna else 1
    masks = rng.randn(B, H, W, M + offset).astype(np.float32)
    masks = np.exp(masks) / np.exp(masks).sum(-1, keepdims=True)
    return {
        'prev': rng.rand(B, H, W, C).astype(np.float32),
        'first': rng.rand(B, H, W, C).astype(np.float32),
        'pd': rng.rand(B, H, W, p).astype(np.float32),
        'fd': rng.rand(B, H, W, p).astype(np.float32),
        'kernels': np.asarray(jwarp.normalize_kernels(
            jnp.asarray(rng.rand(B, K, K, M).astype(np.float32)))),
        'masks': masks.astype(np.float32),
        'raw': rng.randn(B, K, K, M).astype(np.float32),
        'transformed': rng.rand(B, H, W, C, M).astype(np.float32),
    }


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, 'max abs err {} > {}'.format(err, tol)


CASES = {
    'normalize_kernels': lambda d, m: m.normalize_kernels(d['raw']),
    'extract_patches': lambda d, m: m.extract_patches(d['prev'], K),
    'cdna_warp': lambda d, m: m.cdna_warp(d['prev'], d['kernels']),
    'effective_pixel_kernels': lambda d, m: m.effective_pixel_kernels(
        d['kernels'], d['masks'], 2),
    'dna_warp': lambda d, m: m.dna_warp(
        d['prev'], m.effective_pixel_kernels(d['kernels'], d['masks'], 2)),
    'composite': lambda d, m: m.composite(d['prev'], d['transformed'],
                                          d['masks'][..., :M + 1]),
    'warp_distribution': lambda d, m: m.warp_distribution(
        d['pd'], d['fd'], d['kernels'], d['masks'][..., 1:]),
    'warp_distribution_raw': lambda d, m: m.warp_distribution(
        d['pd'], d['fd'], d['kernels'], d['masks'][..., 1:],
        renormalize=False),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_cdna_warp_function_matches_jax(name):
    d = _inputs()
    want = CASES[name]({k: jnp.asarray(v) for k, v in d.items()}, jwarp)
    got = CASES[name]({k: _t(v) for k, v in d.items()}, twarp)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize('sna', [True, False])
def test_plain_tail_matches_both_pallas_kernels(sna):
    d = _inputs(1, sna=sna)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    offset = 2 if sna else 1
    want_eff = fused_warp_composite(j['prev'], j['first'], j['pd'], j['fd'],
                                    j['kernels'], j['masks'], sna=sna,
                                    block_b=2, interpret=True)
    eff = jwarp.effective_pixel_kernels(j['kernels'], j['masks'], offset)
    want_chw = fused_warp_composite_chw(j['prev'], j['first'], j['pd'],
                                        j['fd'], eff, j['masks'][..., :offset],
                                        sna=sna, block_b=2, interpret=True)
    before = cdna_tail.fused_warp_composite.launches
    got = cdna_tail.fused_warp_composite(
        *(_t(d[k]) for k in ('prev', 'first', 'pd', 'fd', 'kernels',
                             'masks')), sna=sna)
    # a CPU tensor takes the plain version and launches nothing
    assert cdna_tail.fused_warp_composite.launches == before
    for want in (want_eff, want_chw):
        _close(got[0], want[0], F32_TOL)
        _close(got[1], want[1], F32_TOL)


@pytest.mark.parametrize('sna', [True, False])
def test_plain_tail_frame_only_matches_xla_tail(sna):
    """P=0: the Pallas kernels cannot be the oracle (both raise
    ZeroDivisionError in interpret mode with P=0), so hold the tail against
    the JAX model's XLA tail (``models/cdna.py`` dna_warp + compositing)."""
    d = _inputs(2, p=0, sna=sna)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    offset = 2 if sna else 1
    eff = jwarp.effective_pixel_kernels(j['kernels'], j['masks'], offset)
    want = j['prev'] * j['masks'][..., 0:1] + jwarp.dna_warp(j['prev'], eff)
    if sna:
        want = want + j['first'] * j['masks'][..., 1:2]
    img, dist = cdna_tail.fused_warp_composite_reference(
        *(_t(d[k]) for k in ('prev', 'first', 'pd', 'fd', 'kernels',
                             'masks')), sna=sna)
    _close(img, want, F32_TOL)
    assert tuple(dist.shape) == (B, H, W, 0)


def test_plain_tail_bf16_matches_pallas():
    d = _inputs(3)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in d.items()}
    want = fused_warp_composite(j['prev'], j['first'], j['pd'], j['fd'],
                                j['kernels'], j['masks'], sna=True,
                                block_b=2, interpret=True)
    got = cdna_tail.fused_warp_composite(
        *(_t(d[k], torch.bfloat16) for k in ('prev', 'first', 'pd', 'fd',
                                             'kernels', 'masks')), sna=True)
    assert got[0].dtype == torch.bfloat16
    _close(got[0], want[0], BF16_TOL)
    _close(got[1], want[1], BF16_TOL)


@pytest.mark.parametrize('r', [2, 4])
@pytest.mark.parametrize('sna', [True, False])
@pytest.mark.parametrize('p', [0, 1])
def test_plain_tail_blocked_masks_equal_full_resolution_masks(r, sna, p):
    """The blocked mask layout is indexing only: the plain tail on blocked
    masks equals the plain tail on ``depth_to_space`` of them, bit for bit."""
    d = _inputs(4, p=p, sna=sna)
    args = [_t(d[k]) for k in ('prev', 'first', 'pd', 'fd', 'kernels')]
    blocked = space_to_depth(_t(d['masks']), r).contiguous()
    assert tuple(blocked.shape) == (B, H // r, W // r,
                                    r * r * d['masks'].shape[-1])
    assert torch.equal(depth_to_space(blocked, r), _t(d['masks']))
    want = cdna_tail.fused_warp_composite_reference(
        *args, depth_to_space(blocked, r), sna=sna)
    for fn in (cdna_tail.fused_warp_composite_reference,
               cdna_tail.fused_warp_composite):   # CPU: the plain version
        got = fn(*args, blocked, sna=sna, mask_block=r)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize('sna', [True, False])
def test_plain_tail_blocked_masks_match_both_pallas_kernels(sna):
    d = _inputs(5, sna=sna)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    offset = 2 if sna else 1
    want_eff = fused_warp_composite(j['prev'], j['first'], j['pd'], j['fd'],
                                    j['kernels'], j['masks'], sna=sna,
                                    block_b=2, interpret=True)
    eff = jwarp.effective_pixel_kernels(j['kernels'], j['masks'], offset)
    want_chw = fused_warp_composite_chw(j['prev'], j['first'], j['pd'],
                                        j['fd'], eff, j['masks'][..., :offset],
                                        sna=sna, block_b=2, interpret=True)
    got = cdna_tail.fused_warp_composite(
        *(_t(d[k]) for k in ('prev', 'first', 'pd', 'fd', 'kernels')),
        space_to_depth(_t(d['masks']), 4).contiguous(), sna=sna, mask_block=4)
    for want in (want_eff, want_chw):
        _close(got[0], want[0], F32_TOL)
        _close(got[1], want[1], F32_TOL)


@pytest.mark.parametrize('c,p,mask_block', [
    (3, 1, 0), (3, 1, 4), (3, 0, 2), (1, 3, 1), (1, 4, 0), (4, 4, 4),
    (3, 2, 4), (4, 4, 0), (3, 2, 3), (3, 1, 8), (3, 1, 3)])
def test_folded_entry_hands_the_kernel_masks_it_reads(c, p, mask_block,
                                                      monkeypatch):
    """On a kernel path (``route`` made to say ``'kernel'``, the launch
    stood in for by the plain version), the folded entry hands the launch
    the masks blocked at r = 2 and 4 and at full resolution at 0, 1 and any
    other block factor (3, 8: expanded, contiguous), and gives exactly what
    the plain version gives on the masks as they came."""
    handed = []

    def launch(*args):
        handed.append((tuple(args[5].shape), args[7],
                       args[5].is_contiguous()))
        return cdna_tail.fused_warp_composite_reference(*args)

    monkeypatch.setattr(cdna_tail, 'route', lambda *tensors: 'kernel')
    monkeypatch.setattr(cdna_tail, '_launch', launch)
    gen = torch.Generator().manual_seed(c * 100 + p * 10 + mask_block)
    b, h, w, m = 2, 24, 48, 3               # h, w divisible by 2, 3, 4 and 8
    full = torch.softmax(torch.randn((b, h, w, m + 2), generator=gen), -1)
    masks = space_to_depth(full, mask_block).contiguous() \
        if mask_block > 1 else full
    kernels = twarp.normalize_kernels(torch.rand((b, K, K, m),
                                                 generator=gen))
    args = [torch.rand((b, h, w, n), generator=gen) for n in (c, c, p, p)]
    args += [kernels, masks]
    got = cdna_tail.fused_warp_composite(*args, sna=True,
                                         mask_block=mask_block)
    want = cdna_tail.fused_warp_composite_reference(*args, sna=True,
                                                    mask_block=mask_block)
    if mask_block in (2, 4):
        assert handed == [(tuple(masks.shape), mask_block, True)]
    else:
        want_r = mask_block if mask_block <= 1 else 0
        assert handed == [((b, h, w, m + 2), want_r, True)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize('h,w,mask_block,tiles', [
    (48, 64, 0, 12), (48, 64, 4, 12), (13, 10, 0, 2), (13, 37, 0, 4),
    (12, 20, 2, 2), (16, 136, 4, 10), (1, 1, 0, 1), (9, 33, 0, 4)])
def test_backward_scratch_has_one_partial_a_tile(h, w, mask_block, tiles):
    """The backward's g_kern scratch: one K*K*M partial for each 8 x 32
    tile of each sample, in either mask layout, odd sizes rounded up."""
    assert cdna_tail.backward_partials_shape(3, h, w, 5, 10, mask_block) == \
        (3, tiles, 250)
    with pytest.raises(ValueError, match='does not divide'):
        cdna_tail.backward_partials_shape(3, 13, 10, 5, 10, 4)


def test_tail_checks_the_blocked_mask_shape():
    """The wrapper's checks, which run before any launch, called directly."""
    d = _inputs(6)
    args = [_t(d[k]) for k in ('prev', 'first', 'pd', 'fd', 'kernels')]
    blocked = space_to_depth(_t(d['masks']), 4).contiguous()
    cdna_tail._check(*args, blocked, True, 4)
    with pytest.raises(ValueError, match='masks has shape'):
        cdna_tail._check(*args, blocked, True, 2)
    with pytest.raises(ValueError, match='does not divide'):
        cdna_tail._check(*args, blocked, True, 5)


def test_tail_raises_on_a_device_without_a_kernel():
    x = torch.zeros((1, 8, 8, 3), device='meta')
    with pytest.raises(ValueError, match='no hand-written kernel'):
        cdna_tail.fused_warp_composite(x, x, x[..., :1], x[..., :1],
                                       torch.zeros((1, 5, 5, 2),
                                                   device='meta'),
                                       torch.zeros((1, 8, 8, 4),
                                                   device='meta'))
