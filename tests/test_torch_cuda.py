"""The port's kernels against their plain versions on the card: the CDNA
tail (its folded entry, its effective-kernel entry and its DNA mode), the
conv-LSTM cell's update with its LayerNorm and the toolchain probe's
``add_one``.

Marked ``cuda``: it needs an NVIDIA card with nvcc and skips elsewhere.  On
the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.

The tail is held against its plain version in both mask layouts (full
resolution and blocked) at the serving shapes (the registration
controller's too, C=3 and P=2: two packed planes, at 48x64 and at the
sawyer registration experiment's 96x128) and at shapes that stress
the tiled kernel's 8 x 64 tiles, four pixels per thread and one or two
planes of packed channels (block factor 3 expanded to full resolution); the
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
unsharded (``chip_smoke.check_sharded_replan``).  The checkpoints: each
vendored orbax step directory restored on the card and replanned against
its numpy export (``chip_smoke.restore_orbax``).

The conv-LSTM kernel (``csrc/conv_lstm_ln.cu``) is held against an f32
composition of the same maths at F 8 to 256, both types, with and without
the recurrent addend, at ragged row counts: c' and h' within one ulp of the
storage type (plus f32 rounding of the terms), y within one ulp plus the
LayerNorm's f32 tolerance of an f32 LayerNorm of the stored h'.  The
flagship's step and a short rollout, and a classic backbone's, through the
kernel against the stock chain (in f32 within 1e-4 of the largest value; in
bf16 no farther from the f32 run than 1.5 times the stock chain): 3
launches a step on the space-to-depth backbone, 5 on the classic one, none
under grad.

The source's stand-alone LayerNorm (``bias_layer_norm``) is held against its
plain version on the CPU at ``ln0``'s and ``ln6``'s shapes with a small
batch, F 32 to 128, both types, contiguous and as ``dec3``'s cropped view,
with and without the convolution's bias: f32 within 1e-6 of 1 + |y| (the
sums in another order), bf16 within that and one ulp (both sides round an
f32 result once).  ``conv_nhwc_norm`` and ``ConvTranspose.forward_norm`` against
the stock chain; 2 launches a classic step, none on the space-to-depth
backbone or under grad.

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
from visual_foresight_torch.models.layers import LN_EPS
from visual_foresight_torch.ops.cdna_warp import normalize_kernels
from visual_foresight_torch.ops.layout import space_to_depth
from visual_foresight_torch.ops.conv_lstm_ln import (
    bias_layer_norm, bias_layer_norm_reference, conv_lstm_ln,
    conv_lstm_ln_reference)
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


# (id, shape); every case runs in the mask layouts of 'blocks' (0: full
# resolution), in both types, on random and on all-ones frames
TAIL_CASES = [
    ('serving-200', dict(b=200, h=48, w=64, blocks=(0, 4))),
    ('serving-768', dict(b=768, h=48, w=64, blocks=(0, 4))),
    ('smaller-than-a-tile', dict(b=2, h=8, w=8, blocks=(0, 2, 4))),
    ('no-multiple-of-the-tile', dict(b=6, h=20, w=36, blocks=(0, 2, 4))),
    ('odd-sizes', dict(b=3, h=13, w=10, blocks=(0,))),
    ('several-tiles-across', dict(b=2, h=16, w=136, blocks=(0, 4))),
    ('batch-1', dict(b=1, h=48, w=64, blocks=(0, 4))),
    ('k3', dict(b=6, h=20, w=36, k=3, blocks=(0, 4))),
    ('k7', dict(b=6, h=20, w=36, k=7, blocks=(0, 4))),
    ('m16', dict(b=6, h=20, w=36, m=16, blocks=(0, 4))),
    ('m7', dict(b=6, h=20, w=36, m=7, blocks=(0, 4))),
    ('sna-off', dict(b=6, h=20, w=36, sna=False, blocks=(0, 4))),
    ('p0', dict(b=6, h=20, w=36, p=0, blocks=(0, 4))),
    ('sna-off-p0', dict(b=6, h=20, w=36, sna=False, p=0, blocks=(0, 2))),
    ('c1-p4', dict(b=6, h=20, w=36, c=1, p=4, blocks=(0, 2))),
    ('block-factor-3', dict(b=6, h=18, w=36, blocks=(3,))),
    # the registration controller's shape: two designated pixels a camera
    # (a task's start and goal registrations), C + P = 5: two packed planes
    ('registration-768-c3-p2', dict(b=768, h=48, w=64, p=2, blocks=(4, 0))),
    # the sawyer registration experiment's: 400 samples a camera at 96x128
    ('registration-96x128-400-c3-p2',
     dict(b=400, h=96, w=128, p=2, blocks=(4, 0))),
    # two packed planes (4 < C + P <= 8) in all three layouts (13 x 10 takes
    # no blocked layout)
    ('two-planes-c3-p3-sna-off',
     dict(b=6, h=20, w=36, p=3, sna=False, blocks=(0, 2, 4))),
    ('two-planes-c4-p4', dict(b=6, h=20, w=36, c=4, p=4, blocks=(0, 2, 4))),
    ('two-planes-c4-p1-k7-m16',
     dict(b=6, h=20, w=36, c=4, p=1, k=7, m=16, blocks=(0, 2, 4))),
    ('two-planes-odd-sizes', dict(b=3, h=13, w=10, p=2, blocks=(0,))),
    ('two-planes-several-tiles-across',
     dict(b=2, h=16, w=136, p=2, blocks=(0, 2, 4))),
    ('two-planes-batch-1',
     dict(b=1, h=48, w=64, p=2, blocks=(0, 2, 4))),
]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', TAIL_CASES, ids=[c[0] for c in TAIL_CASES])
def test_tail_kernel_variants_match_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _, shape = case
    shape = dict(shape)
    blocks = shape.pop('blocks')
    sna = shape.get('sna', True)
    gen = torch.Generator(device='cuda').manual_seed(2)
    for mask_block in blocks:
        for ones in (False, True):
            args = _tail_args(gen, dtype, mask_block=mask_block, ones=ones,
                              **shape)
            before = (fused_warp_composite.launches,
                      fused_warp_composite.blocked_launches)
            got = fused_warp_composite(*args, sna=sna, mask_block=mask_block)
            want = fused_warp_composite_reference(*args, sna=sna,
                                                  mask_block=mask_block)
            torch.cuda.synchronize()
            assert (fused_warp_composite.launches - before[0],
                    fused_warp_composite.blocked_launches - before[1]) == \
                (1, int(mask_block in (2, 4)))
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
    the same injected normals, scores rtol 1e-5, the same visualised elites
    (where the plain replan scores several samples alike within that
    tolerance, as the seeded model does, any one of that tied group); the
    kernel launches once per model step (1 + 3 x 6)."""
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
    last = want['scores_per_itr'][-1]
    shown = got['vis']['indices'].reshape(-1).tolist()
    assert len(set(shown)) == len(shown)
    for g, w in zip(shown, want['vis']['indices'].reshape(-1).tolist()):
        tied = torch.isclose(last, last[w], rtol=1e-5, atol=0)
        if int(tied.sum()) == 1:
            assert g == w
        else:
            assert bool(tied[g]), (g, w)
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


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['xz_flagship', 'ag_r5f_v2'])
def test_orbax_restored_replan_equals_the_numpy_one_on_card(name):
    """``benchmarks/models/<name>`` restored on the card from its orbax
    step directory (the port's OCDBT, zarr and zstd readers) equals the
    numpy export's restore bit for bit, and its 200 x 15 x 3 bf16 replan
    equals the numpy-served one on the same draws, 46 tiled launches each
    (``chip_smoke.py``'s phase 14)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import chip_smoke
    orbax, numpy_pred, _ = chip_smoke.restore_orbax(name, 'card')
    paths = chip_smoke.replan_orbax_and_numpy(name, orbax, numpy_pred)
    assert [n['cdna_tail'] for n in paths.values()] == \
        [chip_smoke.LAUNCHES_PER_REPLAN] * 2


# a rollout through the kernel against the stock chain: in f32 the same
# arithmetic but for the order of a few operations (measured on an H100:
# 5e-6 of the largest value); in bf16 both round, so each is held to an f32
# run of the same weights, the kernel's rms gap at most this many times the
# stock chain's (measured: 0.61-1.09)
ROLLOUT_F32_RTOL = 1e-4
ROLLOUT_BF16_GAP_RATIO = 1.5


def _ulp(ref, dtype):
    """One ulp of ``dtype`` at each value of the f32 tensor ``ref``."""
    _, exp = torch.frexp(ref)
    return torch.ldexp(torch.full_like(ref, torch.finfo(dtype).eps), exp - 1)


def _lstm_f32(x, r, c):
    """The kernel's cell update composed in f32: (c', h') before
    rounding."""
    z = x.float() + (0.0 if r is None else r.float())
    i, g, f, o = torch.split(z, c.shape[-1], dim=-1)
    c32 = torch.sigmoid(f + 1.0) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    return c32, torch.sigmoid(o) * torch.tanh(c32)


@pytest.mark.cuda
@pytest.mark.parametrize('lead', [(997,), (3, 5, 7)], ids=['997', '3x5x7'])
@pytest.mark.parametrize('with_r', [False, True], ids=['x', 'x+r'])
@pytest.mark.parametrize('feat', [8, 32, 128, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_conv_lstm_ln_kernel_matches_f32_on_card(dtype, feat, with_r, lead):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator(device='cuda').manual_seed(feat)
    rand = lambda *s: torch.randn(s, generator=gen, device='cuda')
    x = (1.5 * rand(*lead, 4 * feat)).to(dtype)
    r = (1.5 * rand(*lead, 4 * feat)).to(dtype) if with_r else None
    c = (2.0 * rand(*lead, feat)).to(dtype)
    weight, bias = 1.0 + 0.3 * rand(feat), 0.3 * rand(feat)
    before = conv_lstm_ln.launches
    with torch.no_grad():
        got_c, got_h, got_y = conv_lstm_ln(x, r, c, weight, bias, LN_EPS)
    torch.cuda.synchronize()
    assert conv_lstm_ln.launches == before + 1
    c32, h32 = _lstm_f32(x, r, c)
    # f32 rounding of the terms the state update sums
    slack = 4 * torch.finfo(torch.float32).eps * (1.0 + c.float().abs())
    for got, ref in ((got_c, c32), (got_h, h32)):
        assert got.dtype == dtype and got.shape == c.shape
        err = (got.float() - ref).abs()
        assert bool((err <= _ulp(ref, dtype) + slack).all()), \
            float((err - _ulp(ref, dtype) - slack).max())
    y32 = torch.nn.functional.layer_norm(got_h.float(), (feat,), weight,
                                         bias, eps=LN_EPS)
    err = (got_y.float() - y32).abs()
    assert got_y.dtype == dtype
    assert bool((err <= _ulp(y32, dtype) + 1e-5 * (1.0 + y32.abs())).all())


@pytest.mark.cuda
def test_conv_lstm_ln_kernel_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    n, feat = 10, 16
    x = torch.randn(n, 4 * feat, device='cuda').bfloat16()
    c = torch.randn(n, feat, device='cuda').bfloat16()
    w, b = torch.ones(feat, device='cuda'), torch.zeros(feat, device='cuda')
    with pytest.raises(ValueError, match='unsupported dtype'):
        conv_lstm_ln(x.half(), None, c.half(), w, b, LN_EPS)
    with pytest.raises(ValueError, match='x is torch.float32'):
        conv_lstm_ln(x.float(), None, c, w, b, LN_EPS)
    with pytest.raises(ValueError, match='weight is torch.bfloat16'):
        conv_lstm_ln(x, None, c, w.bfloat16(), b, LN_EPS)
    wide = torch.randn(n, 8 * feat, device='cuda').bfloat16()
    with pytest.raises(ValueError, match='contiguous'):
        conv_lstm_ln(wide[:, ::2], None, c, w, b, LN_EPS)
    with pytest.raises(ValueError, match='16-byte'):
        conv_lstm_ln(wide.view(-1)[1:1 + x.numel()].view_as(x), None, c, w,
                     b, LN_EPS)
    with pytest.raises(ValueError, match='shape'):
        conv_lstm_ln(x[:-1], None, c, w, b, LN_EPS)
    with pytest.raises(ValueError, match='no conv_lstm_ln kernel for 12'):
        conv_lstm_ln(x[:, :48].contiguous(), None, c[:, :12].contiguous(),
                     w[:12], b[:12], LN_EPS)
    with pytest.raises(RuntimeError, match='no backward kernel'):
        conv_lstm_ln(x.requires_grad_(), None, c, w, b, LN_EPS)
    with torch.no_grad():
        conv_lstm_ln(x, None, c, w, b, LN_EPS)      # the same under no_grad


def _step_and_rollout(model, b, steps=5):
    """One step and a ``steps``-step rollout of ``model`` from a seeded
    context broadcast to ``b`` samples, in f32, and the launches they took
    of the conv-LSTM kernel and of the stand-alone LayerNorm."""
    from visual_foresight_torch.models.cdna import broadcast_carry
    gen = torch.Generator(device='cuda').manual_seed(0)
    h, w = 48, 64
    images = torch.rand((1, 2, h, w, 3), generator=gen, device='cuda')
    distribs = torch.zeros((1, 2, h, w, 1), device='cuda')
    distribs[:, :, 24, 32] = 1.0
    states = 0.05 * torch.randn((1, 2, 3), generator=gen, device='cuda')
    ctx_actions = torch.zeros((1, 1, 3), device='cuda')
    actions = 0.05 * torch.randn((b, steps, 3), generator=gen, device='cuda')
    before = conv_lstm_ln.launches, bias_layer_norm.launches
    with torch.no_grad():
        carry = broadcast_carry(model.encode_context(
            images, ctx_actions, states, distribs), b)
        _, (img, distrib, _) = model.step(carry, actions[:, 0],
                                          decode=model._decode())
        roll = model.rollout_from(carry, actions)
    torch.cuda.synchronize()
    out = {'step_images': img, 'step_distribs': distrib,
           'gen_images': roll['gen_images'],
           'gen_distribs': roll['gen_distribs']}
    return {k: v.float() for k, v in out.items()}, \
        (conv_lstm_ln.launches - before[0],
         bias_layer_norm.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize('arch', ['flagship', 'classic'])
def test_conv_lstm_ln_rollout_matches_stock_chain_on_card(arch, monkeypatch):
    """The restored flagship (space-to-depth r=4, F 128/256) at B=768, and
    a seeded classic backbone (F 32/64/128) at B=200, each in bf16 and in
    f32 with the bf16 weights: one step and a 5-step rollout through the
    kernel against the stock chain (``ROLLOUT_F32_RTOL``,
    ``ROLLOUT_BF16_GAP_RATIO``); the kernel launches once a cell and step
    (3 and 5), the stock chain never; the stand-alone LayerNorm twice a
    classic step (``ln0``, ``ln6``) on both sides, never on the flagship."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models import layers
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    if arch == 'flagship':
        from visual_foresight_torch.parallel.flagship_check import (
            load_flagship_predictor)
        m16 = load_flagship_predictor(num_samples=768).models[0]
        m32 = load_flagship_predictor(num_samples=768,
                                      dtype='float32').models[0]
        b, cells, norms = 768, 3, 0
    else:
        from visual_foresight_torch.models.cdna import CDNAPredictor
        torch.manual_seed(0)
        make = lambda dtype: CDNAPredictor(
            (48, 64), num_distribs=1, enc_features=(32, 64, 128),
            separable_lstm=True, std_factor=0, dtype=dtype).cuda().eval()
        m32, m16 = make(torch.float32), make(torch.bfloat16)
        m16.load_state_dict(m32.state_dict())
        b, cells, norms = 200, 5, 2
    m32.load_state_dict(m16.state_dict())
    k16, n16 = _step_and_rollout(m16, b)
    k32, n32 = _step_and_rollout(m32, b)
    monkeypatch.setattr(layers, 'conv_lstm_ln', conv_lstm_ln_reference)
    s16, stock16 = _step_and_rollout(m16, b)
    s32, stock32 = _step_and_rollout(m32, b)
    # the context step, the single step, the rollout
    steps = 1 + 1 + 5
    assert n16 == n32 == (cells * steps, norms * steps)
    assert stock16 == stock32 == (0, norms * steps)
    rms = lambda d: float(d.pow(2).mean().sqrt())
    for key in k32:
        scale = float(s32[key].abs().max())
        assert float((k32[key] - s32[key]).abs().max()) <= \
            ROLLOUT_F32_RTOL * scale, key
        assert rms(k16[key] - k32[key]) <= \
            ROLLOUT_BF16_GAP_RATIO * rms(s16[key] - k32[key]), key


@pytest.mark.cuda
def test_conv_lstm_ln_route_under_grad_keeps_stock_ops_on_card():
    """A train-mode forward with gradients takes the stock chain (no
    launch) and back-propagates; the same model under no_grad launches."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models.cdna import CDNAPredictor
    torch.manual_seed(0)
    model = CDNAPredictor((16, 16), num_distribs=0, num_masks=2,
                          enc_features=(8, 16, 16), lstm_kernel=3,
                          separable_lstm=True, std_factor=4).cuda()
    images = torch.rand((2, 3, 16, 16, 3), device='cuda')
    actions = torch.randn((2, 3, 3), device='cuda')
    before = conv_lstm_ln.launches
    out = model(images, actions)
    out['gen_images'].sum().backward()
    assert conv_lstm_ln.launches == before
    assert all(p.grad is not None for p in model.parameters()
               if p.requires_grad)
    with torch.no_grad():
        model(images, actions)
    assert conv_lstm_ln.launches == before + 3 * 3


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['dense', 'separable', 'external_x'])
def test_forward_norm_routes_by_grad_need_on_card(form, monkeypatch):
    """A cell on the card in each form: under ``no_grad`` ``forward_norm``
    calls the kernel's entry once (with the recurrent addend only under
    ``external_x``) and matches the stock chain in f32; under grad with
    parameters that need a gradient it never calls it and gives the stock
    chain's gradients; under grad with nothing needing one it calls it
    again."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models import layers
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    calls = []

    def entry(*args):
        calls.append(args)
        return conv_lstm_ln(*args)

    torch.manual_seed(0)
    feat, cin = 8, 5
    cell = layers.ConvLSTMCell(cin, feat, (3, 3),
                               separable=form == 'separable',
                               external_x=form == 'external_x').cuda()
    ln = layers.LayerNorm(feat).cuda()
    params = list(cell.parameters()) + list(ln.parameters())
    with torch.no_grad():
        for p in params:
            p.copy_(0.3 * torch.randn(p.shape))
    x = torch.randn(2, 6, 8, 4 * feat if form == 'external_x' else cin,
                    device='cuda')
    state = tuple(torch.randn(2, 6, 8, feat, device='cuda')
                  for _ in range(2))

    def stock():
        new_c, new_h = layers.lstm_update_reference(
            *cell._gate_addends(state[1], x), state[0])
        return new_c, new_h, ln(new_h)

    want = stock()
    monkeypatch.setattr(layers, 'conv_lstm_ln', entry)
    with torch.no_grad():
        (c, h), y = cell.forward_norm(state, x, ln)
    assert len(calls) == 1
    assert (calls[0][1] is None) == (form != 'external_x')
    for got, ref in zip((c, h, y), want):
        torch.testing.assert_close(got, ref, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])

    (c, h), y = cell.forward_norm(state, x, ln)       # grad: stock ops
    assert len(calls) == 1 and y.requires_grad
    (y.sum() + c.sum()).backward()
    got_grads = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    ref_c, _, ref_y = stock()
    (ref_y.sum() + ref_c.sum()).backward()
    for g, p in zip(got_grads, params):
        torch.testing.assert_close(g, p.grad, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])

    for p in params:
        p.requires_grad_(False)
    cell.forward_norm(state, x, ln)          # grad on, nothing needs one
    assert len(calls) == 2


@pytest.mark.cuda
def test_classic_replan_counts_its_launches_on_card():
    """A replan of the classic backbone at its published widths (F
    32/64/128, 5x5 separable gates, 10 masks of 5x5, 48x64, bf16) at 16
    samples x 3 steps x 2 iterations: 5 launches of the conv-LSTM kernel a
    model step, 2 of the stand-alone LayerNorm (``ln0``, ``ln6``) and one
    of the tail a step (the context step at batch 1 too), every one the
    folded tail on full-resolution masks; no blocked masks, no DNA
    launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import numpy as np
    from visual_foresight_torch.models.cdna import CDNAPredictor
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import ActionSpec
    torch.manual_seed(0)
    model = CDNAPredictor((48, 64), num_distribs=1, enc_features=(32, 64, 128),
                          lstm_kernel=5, separable_lstm=True, std_factor=0,
                          renorm_distribs=False,
                          dtype=torch.bfloat16).cuda().eval()
    stds = (0.05, 0.5, 2.0)
    spec = ActionSpec(adim=3, nactions=3, repeat=1, per_dim_std=stds,
                      clip_dims_xy=(0,), clip_dims_rot=(), rej_dims_xy=(),
                      rej_dims_lift=(), xy_std=stds[0], lift_std=stds[1])
    planner = FusedCEMPlanner(spec, 16, iterations=2, k_elite=4, n_vis=2,
                              device='cuda')
    rng = np.random.RandomState(0)
    distribs = np.zeros((1, 2, 48, 64, 1), np.float32)
    distribs[:, :, 24, 32, 0] = 1.0
    counters = lambda: (conv_lstm_ln.launches, bias_layer_norm.launches,
                        fused_warp_composite.launches,
                        fused_warp_composite.blocked_launches,
                        fused_warp_composite_dna.launches)
    before = counters()
    planner.replan([model], rng.rand(1, 2, 48, 64, 3),
                   rng.randn(2, 3) * 0.05, distribs, rng.randn(1, 3) * 0.05,
                   distance_grid([[[10.0, 50.0]]], 48, 64, device='cuda'),
                   np.zeros(9), np.diag(np.tile(np.square(stds), 3)),
                   noise=rng.randn(2, 16, 9))
    torch.cuda.synchronize()
    steps = 1 + 2 * 3
    after = counters()
    assert [a - b for a, b in zip(after, before)] == \
        [5 * steps, 2 * steps, steps, 0, 0]


# (label, leading shape, F): ln0's and ln6's shapes at a small batch, and
# the classic backbone's other widths
NORM_CASES = [('ln0', (3, 24, 32), 32), ('ln6', (3, 48, 64), 32),
              ('F64', (2, 12, 16), 64), ('F128', (2, 6, 8), 128)]
NORM_F32_TOL = 1e-6


def _norm_input(gen, lead, feat, dtype, layout):
    """A (B, H, W, F) input of ``dtype``: contiguous, or the crop of an
    uncropped (B, H + 1, W + 1, F) product, as ``dec3``'s."""
    b, h, w = lead
    pad = 1 if layout == 'crop' else 0
    full = (2.0 * torch.randn((b, h + pad, w + pad, feat), generator=gen,
                              device='cuda') + 0.5).to(dtype)
    return full[:, :h, :w] if pad else full


def _assert_norm_close(got, want, dtype):
    """Within ``NORM_F32_TOL`` of 1 + |want| (the f32 sums in another
    order), and in bf16 one ulp of ``want`` more: two f32 results that
    close may round to neighbouring bf16 values, and near 0, where the
    affine map's terms cancel, their gap spans many ulps of the result."""
    err = (got.float() - want).abs()
    tol = NORM_F32_TOL * (1.0 + want.abs())
    if dtype == torch.bfloat16:
        tol = tol + _ulp(want, dtype)
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize('with_bias', [False, True], ids=['no-bias', 'bias'])
@pytest.mark.parametrize('layout', ['contiguous', 'crop'])
@pytest.mark.parametrize('case', NORM_CASES, ids=[c[0] for c in NORM_CASES])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_bias_layer_norm_kernel_matches_reference_on_card(dtype, case, layout,
                                                          with_bias):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    _, lead, feat = case
    gen = torch.Generator(device='cuda').manual_seed(feat)
    x = _norm_input(gen, lead, feat, dtype, layout)
    rand = lambda *s: torch.randn(s, generator=gen, device='cuda')
    conv_bias = rand(feat).to(dtype) if with_bias else None
    weight, bias = 1.0 + 0.3 * rand(feat), 0.3 * rand(feat)
    before = bias_layer_norm.launches
    with torch.no_grad():
        got = bias_layer_norm(x, conv_bias, weight, bias, LN_EPS)
    torch.cuda.synchronize()
    assert bias_layer_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    cpu = lambda t: None if t is None else t.cpu()
    want = bias_layer_norm_reference(cpu(x), cpu(conv_bias), cpu(weight),
                                     cpu(bias), LN_EPS)
    _assert_norm_close(got.cpu(), want.float(), dtype)


@pytest.mark.cuda
def test_bias_layer_norm_kernel_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    feat = 32
    x = torch.randn(2, 4, 6, feat, device='cuda').bfloat16()
    cb = torch.randn(feat, device='cuda').bfloat16()
    w, b = torch.ones(feat, device='cuda'), torch.zeros(feat, device='cuda')
    flat = torch.randn(x.numel() + 8, device='cuda').bfloat16()
    with pytest.raises(ValueError, match='16-byte'):
        bias_layer_norm(flat[1:1 + x.numel()].view_as(x), cb, w, b, LN_EPS)
    # rows 36 values apart: every other row off a 16-byte boundary
    wide = torch.randn(2, 4, 6, feat + 4, device='cuda').bfloat16()
    with pytest.raises(ValueError, match='every row'):
        bias_layer_norm(wide[..., :feat], cb, w, b, LN_EPS)
    with pytest.raises(ValueError, match='channel stride'):
        bias_layer_norm(x.transpose(-1, -2).contiguous().transpose(-1, -2),
                        cb, w, b, LN_EPS)
    with pytest.raises(ValueError, match='conv_bias is torch.float32'):
        bias_layer_norm(x, cb.float(), w, b, LN_EPS)
    with pytest.raises(ValueError, match='unsupported dtype'):
        bias_layer_norm(x.half(), cb.half(), w, b, LN_EPS)
    with pytest.raises(ValueError, match='weight is torch.bfloat16'):
        bias_layer_norm(x, cb, w.bfloat16(), b, LN_EPS)
    with pytest.raises(ValueError, match='shape'):
        bias_layer_norm(x, cb[:16], w, b, LN_EPS)
    with pytest.raises(ValueError, match='no bias_layer_norm kernel for 24'):
        bias_layer_norm(x[..., :24].contiguous(), None, w[:24], b[:24],
                        LN_EPS)
    with pytest.raises(RuntimeError, match='no backward kernel'):
        bias_layer_norm(x.clone().requires_grad_(), cb, w, b, LN_EPS)
    with torch.no_grad():
        bias_layer_norm(x.clone().requires_grad_(), cb, w, b, LN_EPS)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('route', ['enc0', 'dec3'])
def test_conv_norm_routes_match_stock_chain_on_card(route, dtype,
                                                    monkeypatch):
    """``conv_nhwc_norm`` (enc0: 5x5 stride 2 SAME, 3 to 32 channels) and
    ``ConvTranspose.forward_norm`` (dec3: 32 to 32) under no_grad: one
    launch, and the stock chain (the convolution with its bias, then the
    stock LayerNorm) within ``_assert_norm_close``'s tolerance: the bias
    add on cuDNN's stored product rounds as the kernel's does."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models import layers
    from visual_foresight_torch.ops.conv_lstm_ln import layer_norm_reference
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    torch.manual_seed(0)
    feat = 32
    ln = layers.LayerNorm(feat).cuda()
    if route == 'enc0':
        conv = torch.nn.Conv2d(3, feat, 5, stride=2, dtype=dtype).cuda()
        x = torch.rand(3, 48, 64, 3, device='cuda').to(dtype)
        fold = lambda: layers.conv_nhwc_norm(x, conv, ln, 'SAME')
        product = lambda: layers.conv_nhwc(x, conv, 'SAME')
    else:
        conv = layers.ConvTranspose(feat, feat, dtype=dtype).cuda()
        x = torch.randn(3, 24, 32, feat, device='cuda').to(dtype)
        fold = lambda: conv.forward_norm(x, ln)
        product = lambda: conv(x)
    with torch.no_grad():
        for p in list(conv.parameters()) + list(ln.parameters()):
            p.copy_(0.3 * torch.randn(p.shape))
        before = bias_layer_norm.launches
        got = fold()
        assert bias_layer_norm.launches == before + 1
        want = layer_norm_reference(product(), ln.weight, ln.bias, LN_EPS)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_norm_close(got, want.float(), dtype)


@pytest.mark.cuda
def test_layer_norm_under_grad_keeps_stock_ops_on_card():
    """``LayerNorm.forward`` on the card: under grad with parameters that
    need a gradient the stock ops (no launch) and their gradients; under
    no_grad one launch of the kernel, within ``NORM_F32_TOL`` of the stock
    ops."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from visual_foresight_torch.models import layers
    from visual_foresight_torch.ops.conv_lstm_ln import layer_norm_reference
    torch.manual_seed(0)
    feat = 64
    ln = layers.LayerNorm(feat).cuda()
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.3 * torch.randn(feat))
        ln.bias.copy_(0.3 * torch.randn(feat))
    x = torch.randn(2, 6, 8, feat, device='cuda')
    before = bias_layer_norm.launches
    y = ln(x)
    assert bias_layer_norm.launches == before and y.requires_grad
    y.square().sum().backward()
    got = ln.weight.grad.clone()
    ln.weight.grad = None
    layer_norm_reference(x, ln.weight, ln.bias, LN_EPS).square().sum() \
        .backward()
    assert torch.equal(got, ln.weight.grad)
    with torch.no_grad():
        y = ln(x)
    assert bias_layer_norm.launches == before + 1
    _assert_norm_close(y, layer_norm_reference(x, ln.weight, ln.bias, LN_EPS),
                       torch.float32)
