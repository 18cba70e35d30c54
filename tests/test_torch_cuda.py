"""The port's kernels against their plain versions on the card: the CDNA
tail (its folded entry, its effective-kernel entry and its DNA mode) and the
toolchain probe's ``add_one``.

Marked ``cuda``: it needs an NVIDIA card with nvcc and skips elsewhere.  On
the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.

The tail is held against its plain version in both mask layouts (full
resolution and blocked) at the serving shapes (the registration
controller's too, C=3 and P=2: two packed planes, at 48x64 and at the
sawyer registration experiment's 96x128) and at shapes that stress
the tiled variant's 8 x 64 tiles, four pixels per thread and one or two
planes of packed channels (the general variant at block factor 3); the
frames are random or all ones, so that a wrong halo shows at the border.  The
effective-kernel entry is held against its plain version at DNA's serving
shapes and at odd sizes, K 3 to 7, P 0 to 4, SNA on and off; the DNA mode
at the same shapes with f32 masks and masks in the compute type, and inside
a small classic-DNA rollout.

The backward kernel of the folded tail (``csrc/cdna_tail_bwd.cu``) is held
against its plain version at the training shapes (B=16 and 256, 48x64,
C=3, M=10) and at sizes that cut its 8 x 32 tiles, in both mask layouts,
SNA on and off, K 3 to 7, both types, all four gradients; two launches must
give the same bits, and the autograd node on the card must give what
autograd of the plain version gives.

The mesh: the tiled tail and its backward on ``cuda:1`` after ``cuda:0``
(the shared-memory opt-in is kept per device; skips with fewer than two
cards), and the flagship's replan over the card repeated twice against
unsharded (``chip_smoke.check_sharded_replan``).

Tolerances: f32 1e-5 (the same f32 arithmetic in another order); bf16 1e-2
(both sides round an f32 result once to bf16, one ulp is 7.8e-3 near 1);
the backward's gradients relative to each gradient's largest magnitude (a
kernel gradient sums thousands of products); ``add_one`` exact (one
correctly rounded add on both sides)."""

import pytest
import torch

from visual_foresight_torch.ops.cdna_tail import (
    fused_warp_composite, fused_warp_composite_backward,
    fused_warp_composite_backward_reference, fused_warp_composite_dna,
    fused_warp_composite_dna_reference, fused_warp_composite_eff,
    fused_warp_composite_eff_reference, fused_warp_composite_reference)
from visual_foresight_torch.ops.cdna_warp import normalize_kernels
from visual_foresight_torch.ops.layout import space_to_depth
from visual_foresight_torch.ops.probe import add_one, add_one_reference

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sna,p', [(True, 1), (False, 1), (True, 0),
                                   (False, 2)])
def test_tail_kernel_matches_plain_on_card(dtype, sna, p):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(0)
    b, h, w, c, k, m = 6, 20, 36, 3, 5, 10
    offset = 2 if sna else 1
    rand = lambda *s: torch.rand(s, generator=gen, device='cuda')
    masks = torch.softmax(torch.randn((b, h, w, m + offset), generator=gen,
                                      device='cuda'), dim=-1)
    args = tuple(t.to(dtype).contiguous() for t in (
        rand(b, h, w, c), rand(b, h, w, c), rand(b, h, w, p),
        rand(b, h, w, p), normalize_kernels(rand(b, k, k, m)), masks))
    before = fused_warp_composite.launches
    got = fused_warp_composite(*args, sna=sna)
    want = fused_warp_composite_reference(*args, sna=sna)
    torch.cuda.synchronize()
    assert fused_warp_composite.launches == before + 1
    for g, r in zip(got, want):
        assert g.dtype == dtype and g.shape == r.shape
        if g.numel():
            assert float((g.float() - r.float()).abs().max()) <= TOL[dtype]


def _tail_args(gen, dtype, b, h, w, c=3, p=1, k=5, m=10, sna=True,
               mask_block=0, ones=False):
    offset = 2 if sna else 1
    frame = lambda *s: torch.ones(s, device='cuda') if ones else \
        torch.rand(s, generator=gen, device='cuda')
    masks = torch.softmax(2.0 * torch.randn(
        (b, h, w, m + offset), generator=gen, device='cuda'), dim=-1)
    if mask_block > 1:
        masks = space_to_depth(masks, mask_block)
    kernels = normalize_kernels(torch.rand((b, k, k, m), generator=gen,
                                           device='cuda'))
    return tuple(t.to(dtype).contiguous() for t in (
        frame(b, h, w, c), frame(b, h, w, c), frame(b, h, w, p),
        frame(b, h, w, p), kernels, masks))


# (id, variant, shape); every case runs in the mask layouts of 'blocks'
# (0: full resolution), in both types, on random and on all-ones frames
TAIL_CASES = [
    ('serving-200', 'tiled', dict(b=200, h=48, w=64, blocks=(0, 4))),
    ('serving-768', 'tiled', dict(b=768, h=48, w=64, blocks=(0, 4))),
    ('smaller-than-a-tile', 'tiled', dict(b=2, h=8, w=8, blocks=(0, 2, 4))),
    ('no-multiple-of-the-tile', 'tiled',
     dict(b=6, h=20, w=36, blocks=(0, 2, 4))),
    ('odd-sizes', 'tiled', dict(b=3, h=13, w=10, blocks=(0,))),
    ('several-tiles-across', 'tiled', dict(b=2, h=16, w=136, blocks=(0, 4))),
    ('batch-1', 'tiled', dict(b=1, h=48, w=64, blocks=(0, 4))),
    ('k3', 'tiled', dict(b=6, h=20, w=36, k=3, blocks=(0, 4))),
    ('k7', 'tiled', dict(b=6, h=20, w=36, k=7, blocks=(0, 4))),
    ('m16', 'tiled', dict(b=6, h=20, w=36, m=16, blocks=(0, 4))),
    ('m7', 'tiled', dict(b=6, h=20, w=36, m=7, blocks=(0, 4))),
    ('sna-off', 'tiled', dict(b=6, h=20, w=36, sna=False, blocks=(0, 4))),
    ('p0', 'tiled', dict(b=6, h=20, w=36, p=0, blocks=(0, 4))),
    ('sna-off-p0', 'tiled',
     dict(b=6, h=20, w=36, sna=False, p=0, blocks=(0, 2))),
    ('c1-p4', 'tiled', dict(b=6, h=20, w=36, c=1, p=4, blocks=(0, 2))),
    ('block-factor-3', 'general', dict(b=6, h=18, w=36, blocks=(3,))),
    # the registration controller's shape: two designated pixels a camera
    # (a task's start and goal registrations), C + P = 5: two packed planes
    ('registration-768-c3-p2', 'tiled',
     dict(b=768, h=48, w=64, p=2, blocks=(4, 0))),
    # the sawyer registration experiment's: 400 samples a camera at 96x128
    ('registration-96x128-400-c3-p2', 'tiled',
     dict(b=400, h=96, w=128, p=2, blocks=(4, 0))),
    # two packed planes (4 < C + P <= 8) in all three layouts (13 x 10 takes
    # no blocked layout)
    ('two-planes-c3-p3-sna-off', 'tiled',
     dict(b=6, h=20, w=36, p=3, sna=False, blocks=(0, 2, 4))),
    ('two-planes-c4-p4', 'tiled',
     dict(b=6, h=20, w=36, c=4, p=4, blocks=(0, 2, 4))),
    ('two-planes-c4-p1-k7-m16', 'tiled',
     dict(b=6, h=20, w=36, c=4, p=1, k=7, m=16, blocks=(0, 2, 4))),
    ('two-planes-odd-sizes', 'tiled', dict(b=3, h=13, w=10, p=2, blocks=(0,))),
    ('two-planes-several-tiles-across', 'tiled',
     dict(b=2, h=16, w=136, p=2, blocks=(0, 2, 4))),
    ('two-planes-batch-1', 'tiled',
     dict(b=1, h=48, w=64, p=2, blocks=(0, 2, 4))),
]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', TAIL_CASES, ids=[c[0] for c in TAIL_CASES])
def test_tail_kernel_variants_match_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _, variant, shape = case
    shape = dict(shape)
    blocks = shape.pop('blocks')
    sna = shape.get('sna', True)
    gen = torch.Generator(device='cuda').manual_seed(2)
    for mask_block in blocks:
        for ones in (False, True):
            args = _tail_args(gen, dtype, mask_block=mask_block, ones=ones,
                              **shape)
            before = dict(fused_warp_composite.launches_by_variant)
            got = fused_warp_composite(*args, sna=sna, mask_block=mask_block)
            want = fused_warp_composite_reference(*args, sna=sna,
                                                  mask_block=mask_block)
            torch.cuda.synchronize()
            after = fused_warp_composite.launches_by_variant
            assert {v: after[v] - before[v] for v in after} == \
                {v: int(v == variant) for v in after}
            for g, r in zip(got, want):
                assert g.dtype == dtype and g.shape == r.shape
                if g.numel():
                    err = float((g.float() - r.float()).abs().max())
                    assert err <= TOL[dtype], (mask_block, ones, err)


@pytest.mark.cuda
def test_tail_kernel_takes_a_batch_slice_on_card():
    """A contiguous slice of a larger batch starts at any 2-byte offset the
    slicing gives; here the tensors start 16-byte aligned or not by the
    parity of the sample they start at (8x8x3 bf16 samples are 384 bytes, 8x8x1
    ones 128), and both the bulk and the per-thread copies must be right."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(3)
    full = _tail_args(gen, torch.bfloat16, b=5, h=12, w=10, mask_block=2)
    for lo in (0, 1, 2):
        args = tuple(t[lo:lo + 3] for t in full)
        got = fused_warp_composite(*args, mask_block=2)
        want = fused_warp_composite_reference(*args, mask_block=2)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert float((g.float() - r.float()).abs().max()) <= \
                TOL[torch.bfloat16]


@pytest.mark.cuda
def test_tail_kernel_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    x = torch.zeros((2, 8, 8, 3), device='cuda')
    d = torch.zeros((2, 8, 8, 1), device='cuda')
    kern = torch.zeros((2, 5, 5, 4), device='cuda')
    masks = torch.zeros((2, 8, 8, 6), device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        fused_warp_composite(x.transpose(1, 2), x, d, d, kern, masks)
    with pytest.raises(ValueError, match='masks has shape'):
        fused_warp_composite(x, x, d, d, kern, masks[..., :5].contiguous())
    with pytest.raises(ValueError, match='is torch.bfloat16'):
        fused_warp_composite(x, x, d, d, kern.bfloat16(), masks)
    with pytest.raises(ValueError, match='masks has shape'):
        fused_warp_composite(x, x, d, d, kern, masks, mask_block=4)
    with pytest.raises(ValueError, match='does not divide'):
        fused_warp_composite(x, x, d, d, kern, masks, mask_block=3)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8, 128), (3, 1000)])
def test_add_one_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(1)
    x = torch.randn(shape, generator=gen, device='cuda') * 1e3
    before = add_one.launches
    got = add_one(x)
    torch.cuda.synchronize()
    assert add_one.launches == before + 1
    assert torch.equal(got, add_one_reference(x))
    with pytest.raises(ValueError, match='float32'):
        add_one(x.double())
    with pytest.raises(ValueError, match='contiguous'):
        add_one(torch.zeros((4, 4), device='cuda').t())


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['odd-length', 'sliced-one-in', 'empty'])
def test_add_one_edge_cases_on_card(case):
    """Exact at an odd length (the vector body and a scalar tail), on a
    tensor sliced one element in (not 16-byte aligned, while its output is)
    and at n = 0."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(3)
    base = torch.randn(4099, generator=gen, device='cuda') * 1e3
    x = {'odd-length': base[:4097], 'sliced-one-in': base[1:],
         'empty': base[:0]}[case]
    got = add_one(x)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.equal(got, add_one_reference(x))


@pytest.mark.cuda
def test_mppi_replan_kernel_matches_plain_tail_on_card(monkeypatch):
    """One MPPI replan of a small f32 model (32 samples x 6 steps x 3
    iterations, 48x64, anchored): the tail kernel against the plain tail on
    the same injected normals, same elites, scores rtol 1e-5; the kernel
    launches once per model step (1 + 3 x 6)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import numpy as np
    from visual_foresight_torch.models import cdna as cdna_model
    from visual_foresight_torch.models.cdna import CDNAPredictor
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import ActionSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = CDNAPredictor((48, 64), num_distribs=1, sdim=5, adim=4,
                          enc_features=(16, 32, 32), lstm_kernel=3,
                          separable_lstm=True, std_factor=4).cuda().eval()
    stds = (0.05, 0.05, 0.2, np.pi / 10)
    spec = ActionSpec(adim=4, nactions=6, repeat=1, per_dim_std=stds,
                      clip_dims_xy=(), clip_dims_rot=(), rej_dims_xy=(),
                      rej_dims_lift=(), xy_std=stds[0], lift_std=stds[2])
    planner = FusedCEMPlanner(
        spec, 32, iterations=3, k_elite=6, n_vis=2, device='cuda',
        mppi={'kappa': 1.0, 'beta_0': 0.5, 'beta_1': 0.5, 'refit_cov': True,
              'mean_bias': None, 'per_dim_std': stds})
    rng = np.random.RandomState(0)
    distribs = np.zeros((1, 2, 48, 64, 1), np.float32)
    distribs[:, :, 24, 32, 0] = 1.0
    args = ([model], rng.rand(1, 2, 48, 64, 3), rng.randn(2, 5) * 0.05,
            distribs, rng.randn(1, 4) * 0.05,
            distance_grid([[[10.0, 50.0]]], 48, 64, device='cuda'),
            np.zeros(24), np.eye(24))
    kw = dict(noise=rng.randn(3, 32, 24), anchor=rng.randn(4) * 0.05,
              anchor_valid=1.0)
    before = fused_warp_composite.launches
    got = planner.replan(*args, **kw)
    torch.cuda.synchronize()
    assert fused_warp_composite.launches == before + 1 + 3 * 6
    monkeypatch.setattr(cdna_model, 'fused_warp_composite',
                        fused_warp_composite_reference)
    want = planner.replan(*args, **kw)
    torch.testing.assert_close(got['scores_per_itr'], want['scores_per_itr'],
                               rtol=1e-5, atol=0)
    assert torch.equal(got['vis']['indices'], want['vis']['indices'])
    torch.testing.assert_close(got['mean'], want['mean'], rtol=1e-5,
                               atol=1e-6)


def _eff_args(gen, dtype, b, h, w, c=3, p=1, k=5, sna=True, ones=False):
    """Frames, a DNA field (normalized kernels weighed by the transform
    masks' total) and the background masks that complete it to one."""
    nbg = 2 if sna else 1
    frame = lambda *s: torch.ones(s, device='cuda') if ones else \
        torch.rand(s, generator=gen, device='cuda')
    masks = torch.softmax(2.0 * torch.randn((b, h, w, nbg + 1), generator=gen,
                                            device='cuda'), dim=-1)
    pk = torch.rand((b, h, w, k * k), generator=gen, device='cuda')
    eff = pk / pk.sum(-1, keepdim=True) * masks[..., nbg:]
    return tuple(t.to(dtype).contiguous() for t in (
        frame(b, h, w, c), frame(b, h, w, c), frame(b, h, w, p),
        frame(b, h, w, p), eff, masks[..., :nbg]))


EFF_CASES = [
    ('serving-768', dict(b=768, h=48, w=64)),
    ('serving-200', dict(b=200, h=48, w=64)),
    ('batch-1', dict(b=1, h=48, w=64)),
    ('odd-sizes', dict(b=3, h=13, w=10)),
    ('k3-p0', dict(b=5, h=20, w=36, k=3, p=0)),
    ('k7-p3-sna-off', dict(b=5, h=20, w=36, k=7, p=3, sna=False)),
    ('c1-p4-wide', dict(b=2, h=9, w=300, c=1, p=4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', EFF_CASES, ids=[c[0] for c in EFF_CASES])
def test_eff_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    shape = dict(case[1])
    sna = shape.get('sna', True)
    gen = torch.Generator(device='cuda').manual_seed(4)
    for ones in (False, True):
        args = _eff_args(gen, dtype, ones=ones, **shape)
        before = fused_warp_composite_eff.launches
        got = fused_warp_composite_eff(*args, sna=sna)
        want = fused_warp_composite_eff_reference(*args, sna=sna)
        torch.cuda.synchronize()
        assert fused_warp_composite_eff.launches == before + 1
        for g, r in zip(got, want):
            assert g.dtype == dtype and g.shape == r.shape
            if g.numel():
                assert float((g.float() - r.float()).abs().max()) <= \
                    TOL[dtype]


def _dna_args(gen, dtype, mask_dtype, b, h, w, c=3, p=1, k=5, sna=True,
              ones=False, m=10):
    """Frames, DNA logits (some below zero) and softmax masks over the
    background and ``m`` transform masks, in ``mask_dtype``."""
    nc = m + (2 if sna else 1)
    frame = lambda *s: torch.ones(s, device='cuda') if ones else \
        torch.rand(s, generator=gen, device='cuda')
    logits = torch.randn((b, h, w, k * k), generator=gen,
                         device='cuda') * 0.5 + 0.3
    masks = torch.softmax(2.0 * torch.randn((b, h, w, nc), generator=gen,
                                            device='cuda'), dim=-1)
    return tuple(t.to(dtype).contiguous() for t in (
        frame(b, h, w, c), frame(b, h, w, c), frame(b, h, w, p),
        frame(b, h, w, p), logits)) + (masks.to(mask_dtype).contiguous(),)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,mask_dtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=['f32', 'bf16-f32-masks', 'bf16'])
@pytest.mark.parametrize('case', EFF_CASES, ids=[c[0] for c in EFF_CASES])
def test_dna_kernel_matches_plain_on_card(case, dtype, mask_dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    shape = dict(case[1])
    sna = shape.get('sna', True)
    gen = torch.Generator(device='cuda').manual_seed(5)
    for ones in (False, True):
        args = _dna_args(gen, dtype, mask_dtype, ones=ones, **shape)
        before = fused_warp_composite_dna.launches
        got = fused_warp_composite_dna(*args, sna=sna)
        want = fused_warp_composite_dna_reference(*args, sna=sna)
        torch.cuda.synchronize()
        assert fused_warp_composite_dna.launches == before + 1
        for g, r in zip(got, want):
            assert g.dtype == dtype and g.shape == r.shape
            if g.numel():
                assert float((g.float() - r.float()).abs().max()) <= \
                    TOL[dtype]


@pytest.mark.cuda
def test_classic_dna_rollout_kernel_matches_plain_on_card(monkeypatch):
    """A small f32 classic-DNA model (48x64, 8 samples, 4 steps): the
    rollout through the DNA mode against the same rollout through its
    plain version, atol 1e-5; one launch a step, none of the field-given
    entry."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models import cdna as cdna_model
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(1)
    model = cdna_model.CDNAPredictor(
        (48, 64), num_distribs=1, dna=True, enc_features=(8, 16, 16),
        lstm_kernel=3, separable_lstm=True).cuda().eval()
    gen = torch.Generator(device='cuda').manual_seed(2)
    imgs = torch.rand((8, 2, 48, 64, 3), generator=gen, device='cuda')
    dists = torch.rand((8, 2, 48, 64, 1), generator=gen, device='cuda')
    acts = torch.randn((8, 4, 3), generator=gen, device='cuda') * 0.1
    with torch.no_grad():
        carry = model.encode_context(imgs, acts[:, :1], None, dists)
        before = (fused_warp_composite_dna.launches,
                  fused_warp_composite_eff.launches)
        got = model.rollout_from(carry, acts)
        torch.cuda.synchronize()
        assert (fused_warp_composite_dna.launches,
                fused_warp_composite_eff.launches) == (before[0] + 4,
                                                       before[1])
        monkeypatch.setattr(cdna_model, 'fused_warp_composite_dna',
                            fused_warp_composite_dna_reference)
        want = model.rollout_from(carry, acts)
    for key in ('gen_images', 'gen_distribs'):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5)


# (id, shape, mask layouts); every case runs in both types, SNA on and off
BWD_CASES = [
    ('train-16', dict(b=16, h=48, w=64), (0, 4)),
    ('odd-sizes', dict(b=3, h=13, w=10), (0,)),
    ('cuts-the-blocks', dict(b=2, h=12, w=20), (0, 2, 4)),
    ('k3', dict(b=2, h=20, w=36, k=3), (0, 4)),
    ('k7', dict(b=2, h=20, w=36, k=7), (0, 4)),
    ('m16-c1', dict(b=2, h=20, w=36, m=16, c=1), (0, 4)),
    ('odd-sizes-cut-tiles', dict(b=2, h=13, w=37), (0,)),
    ('several-tiles-across', dict(b=2, h=16, w=136), (0, 2, 4)),
    ('batch-1', dict(b=1, h=48, w=64), (0, 4)),
    ('blocked-r2', dict(b=4, h=24, w=40), (2,)),
    ('train-256', dict(b=256, h=48, w=64), (4,)),
]


def _bwd_args(gen, dtype, b, h, w, c=3, k=5, m=10, sna=True, mask_block=0):
    """(grad_img, prev, first, kernels, masks) for the backward, P = 0."""
    args = _tail_args(gen, dtype, b, h, w, c=c, p=0, k=k, m=m, sna=sna,
                      mask_block=mask_block)
    grad = torch.randn((b, h, w, c), generator=gen, device='cuda')
    return (grad.to(dtype),) + args[:2] + args[4:]


def _rel_err(got, want):
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                   1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize('sna', [True, False], ids=['sna', 'no-sna'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_tail_backward_kernel_matches_plain_on_card(case, dtype, sna):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _, shape, blocks = case
    gen = torch.Generator(device='cuda').manual_seed(3)
    for mask_block in blocks:
        args = _bwd_args(gen, dtype, sna=sna, mask_block=mask_block, **shape)
        before = fused_warp_composite_backward.launches
        got = fused_warp_composite_backward(*args, sna=sna,
                                            mask_block=mask_block)
        want = fused_warp_composite_backward_reference(
            *args, sna=sna, mask_block=mask_block)
        torch.cuda.synchronize()
        assert fused_warp_composite_backward.launches == before + 1
        for name, g, r in zip(('prev', 'first', 'kernels', 'masks'), got,
                              want):
            assert g.dtype == dtype and g.shape == r.shape
            err = _rel_err(g, r)
            assert err <= TOL[dtype], (mask_block, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [16, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_tail_backward_kernel_is_deterministic_on_card(dtype, batch):
    """Two launches on the same inputs give the same bits (the kernels'
    gradient is summed in a fixed order, no atomics); an output not asked
    for comes back as None."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(4)
    args = _bwd_args(gen, dtype, batch, 48, 64, mask_block=4)
    one = fused_warp_composite_backward(*args, mask_block=4)
    two = fused_warp_composite_backward(*args, mask_block=4)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    some = fused_warp_composite_backward(
        *args, mask_block=4, needs=(True, False, True, False))
    assert some[1] is None and some[3] is None
    assert torch.equal(some[0], one[0]) and torch.equal(some[2], one[2])


@pytest.mark.cuda
@pytest.mark.parametrize('mask_block', [0, 4], ids=['full', 'blocked'])
def test_tail_autograd_on_card_matches_plain_autograd(mask_block):
    """Gradients through the folded entry on the card (the forward kernel,
    then the backward kernel) against autograd of the plain version on the
    CPU, f32, 1e-5 of each gradient's largest magnitude; ``first`` needs no
    gradient and gets none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(5)
    grad, prev, first, kernels, masks = _bwd_args(
        gen, torch.float32, 4, 48, 64, mask_block=mask_block)
    empty = prev[..., :0]
    grads = []
    for dev in ('cuda', 'cpu'):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (prev, kernels, masks)]
        before = fused_warp_composite_backward.launches
        out, _ = fused_warp_composite(leaves[0], first.to(dev),
                                      empty.to(dev), empty.to(dev),
                                      *leaves[1:], mask_block=mask_block)
        out.backward(grad.to(dev))
        assert fused_warp_composite_backward.launches == \
            before + (dev == 'cuda')
        grads.append([t.grad.cpu() for t in leaves])
    for g, r in zip(*grads):
        assert _rel_err(g, r) <= 1e-5


@pytest.mark.cuda
def test_entries_without_a_backward_raise_under_grad_on_card():
    """The field-given entry, the DNA mode, and the folded entry with
    distribution channels, asked for a gradient on the card, raise instead
    of returning a result cut off from the graph; under ``no_grad`` they
    run."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(6)
    eff = _eff_args(gen, torch.float32, 2, 16, 16)
    dna = _dna_args(gen, torch.float32, torch.float32, 2, 16, 16)
    tail = _tail_args(gen, torch.float32, 2, 16, 16)
    for fn, args in ((fused_warp_composite_eff, eff),
                     (fused_warp_composite_dna, dna),
                     (fused_warp_composite, tail)):
        leaf = args[4].clone().requires_grad_()
        call = args[:4] + (leaf,) + args[5:]
        with pytest.raises(RuntimeError, match='backward'):
            fn(*call)
        with torch.no_grad():
            fn(*call)


@pytest.mark.cuda
def test_robot_twin_episode_on_card(tmp_path):
    """One fake-arm trajectory of ``campaigns/robot_sawyer_pixel_cost.py``
    through ``run_robot`` on the card (``chip_smoke.py``'s phase 10 at one
    trajectory): two test-pattern camera nodes at 640x480, the two-view
    model, 2 replans of 2 views x (1 + 3 x 15) tiled tail launches, the raw
    folder, the stats by hand and the clips."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import chip_smoke
    channels, topics = chip_smoke.robot_cameras()
    model = chip_smoke.robot_model_dir(str(tmp_path / 'model'))
    config = chip_smoke.robot_config(model, str(tmp_path / 'result'), 0,
                                     env={'camera_topics': topics})
    per_replan = 2 * chip_smoke.replan_launches(config['policy'])
    log = chip_smoke.ReplanClock(torch.cuda.synchronize)
    with chip_smoke.CameraNodes(channels, *chip_smoke.ROBOT_FRAME):
        clicks, _, ctrl = chip_smoke.run_robot_twin(config, log)
    assert ctrl.predictor.restored and ctrl.device.type == 'cuda'
    assert log.launches == [per_replan] * 2 and per_replan == 92
    chip_smoke.check_robot_trajs(str(tmp_path / 'result'), (0,), clicks,
                                 config['agent']['T'], True)


@pytest.mark.cuda
def test_tiled_tail_and_backward_on_a_second_card():
    """The tiled tail (53,648 bytes of shared memory a block at the serving
    shape: above the 48 KB that needs a per-device opt-in) and its backward
    on ``cuda:1`` after ``cuda:0`` in one process, each against its plain
    version on that card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    for index in (0, 1):
        device = torch.device('cuda', index)
        gen = torch.Generator(device=device).manual_seed(index)
        with torch.cuda.device(device):
            args = _tail_args(gen, torch.bfloat16, 200, 48, 64,
                              mask_block=4)
            got = fused_warp_composite(*args, sna=True, mask_block=4)
            want = fused_warp_composite_reference(*args, sna=True,
                                                  mask_block=4)
            bwd = _bwd_args(gen, torch.bfloat16, 16, 48, 64, mask_block=4)
            g_got = fused_warp_composite_backward(*bwd, sna=True,
                                                  mask_block=4)
            g_want = fused_warp_composite_backward_reference(
                *bwd, sna=True, mask_block=4)
            torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert g.device == device
            assert float((g.float() - r.float()).abs().max()) <= \
                TOL[torch.bfloat16]
        for g, r in zip(g_got, g_want):
            assert g.device == device
            assert _rel_err(g, r) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_sharded_flagship_replan_on_one_card():
    """The flagship's replan (48x64, M=200, bf16, restored) over the card
    repeated twice equals the unsharded replan as ``chip_smoke.py``'s phase
    13 holds it: the first iteration's scores at JAX's flagship tolerance
    and the best plans, in bf16 where its elites and scores agree, else
    both again in f32."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import chip_smoke
    from visual_foresight_torch.parallel.mesh import Mesh
    replan = chip_smoke.flagship_runner()
    mesh = Mesh((torch.device('cuda', 0),) * 2)
    plain = replan(None)
    before = fused_warp_composite.launches
    got = replan(mesh)
    assert fused_warp_composite.launches - before == \
        chip_smoke.mesh_launches(2)
    chip_smoke.check_sharded_replan('flagship over cuda:0 twice', got, plain,
                                    replan, mesh)
