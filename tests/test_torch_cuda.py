"""The port's kernels against their plain versions on the card: the CDNA
tail and the toolchain probe's ``add_one``.

Marked ``cuda``: it needs an NVIDIA card with nvcc and skips elsewhere.  On
the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: f32 1e-5 (the same f32 arithmetic in another order); bf16 1e-2
(both sides round an f32 result once to bf16, one ulp is 7.8e-3 near 1);
``add_one`` exact (one correctly rounded add on both sides)."""

import pytest
import torch

from visual_foresight_torch.ops.cdna_tail import (
    fused_warp_composite, fused_warp_composite_reference)
from visual_foresight_torch.ops.cdna_warp import normalize_kernels
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
