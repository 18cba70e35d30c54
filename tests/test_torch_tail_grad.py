"""Port parity: the gradient of the plain CDNA tail
(``ops/cdna_tail.py::fused_warp_composite_reference`` under autograd, and
its explicit backward ``fused_warp_composite_backward_reference``) against
``jax.vjp`` of the JAX package's XLA tail: ``effective_pixel_kernels``,
``dna_warp`` and the compositing of its ``models/cdna.py`` step.  Inputs
come from numpy with a fixed seed; both mask layouts (full resolution and
blocked by 4, the blocked gradient compared after ``depth_to_space``), SNA
on and off, K 3, 5 and 7, P = 0.

Tolerance: f32, 1e-5 of each gradient's largest magnitude (the same sums in
another order; a kernel gradient sums over every pixel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_tpu.ops import cdna_warp as jwarp
from visual_foresight_torch.ops import cdna_tail
from visual_foresight_torch.ops.layout import depth_to_space, space_to_depth

REL_TOL = 1e-5
B, H, W, C, M = 2, 16, 24, 3, 4
NAMES = ('prev', 'first', 'kernels', 'masks')


def _inputs(seed, k, sna):
    rng = np.random.RandomState(seed)
    nc = M + (2 if sna else 1)
    logits = 2.0 * rng.randn(B, H, W, nc)
    masks = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    raw = rng.rand(B, k, k, M)
    return {'prev': rng.rand(B, H, W, C), 'first': rng.rand(B, H, W, C),
            'kernels': raw / raw.sum(axis=(1, 2), keepdims=True),
            'masks': masks, 'grad': rng.randn(B, H, W, C)}


def _jax_tail(prev, first, kernels, masks, sna):
    """The JAX step's XLA tail for P = 0 (``models/cdna.py``, the
    non-Pallas branch)."""
    offset = 2 if sna else 1
    out = prev * masks[..., 0:1]
    if sna:
        out = out + first * masks[..., 1:2]
    eff = jwarp.effective_pixel_kernels(kernels, masks, offset)
    return out + jwarp.dna_warp(prev, eff)


def _jax_grads(d, sna):
    args = [jnp.asarray(d[n], jnp.float32) for n in NAMES]
    _, vjp = jax.vjp(lambda *a: _jax_tail(*a, sna), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(d['grad'], jnp.float32))]


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize('k', [3, 5, 7])
@pytest.mark.parametrize('sna', [True, False], ids=['sna', 'no-sna'])
@pytest.mark.parametrize('mask_block', [0, 4], ids=['full', 'blocked'])
def test_plain_tail_gradients_match_jax_vjp(mask_block, sna, k):
    d = _inputs(k, k, sna)
    want = _jax_grads(d, sna)
    t = {n: torch.tensor(d[n], dtype=torch.float32) for n in NAMES}
    if mask_block:
        t['masks'] = space_to_depth(t['masks'], mask_block).contiguous()
    leaves = {n: t[n].clone().requires_grad_() for n in NAMES}
    empty = torch.zeros((B, H, W, 0))
    out, _ = cdna_tail.fused_warp_composite_reference(
        leaves['prev'], leaves['first'], empty, empty, leaves['kernels'],
        leaves['masks'], sna, mask_block)
    out.backward(torch.tensor(d['grad'], dtype=torch.float32))
    explicit = cdna_tail.fused_warp_composite_backward_reference(
        torch.tensor(d['grad'], dtype=torch.float32), t['prev'], t['first'],
        t['kernels'], t['masks'], sna, mask_block)
    for name, w, e in zip(NAMES, want, explicit):
        got = leaves[name].grad
        if name == 'first' and not sna:     # unread without SNA
            assert got is None and not e.any() and not w.any()
            continue
        if name == 'masks' and mask_block:
            got, e = (depth_to_space(x, mask_block) for x in (got, e))
        assert _rel_err(got.numpy(), w) <= REL_TOL, name
        assert _rel_err(e.numpy(), w) <= REL_TOL, name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_explicit_backward_equals_autograd_of_the_plain_tail(dtype):
    """The explicit backward reference against autograd of the plain
    forward, blocked masks, SNA, in both types (bf16: both round the same f32
    gradient once; 1e-2 of the largest magnitude, a bf16 ulp is 3.9e-3 of
    it)."""
    d = _inputs(11, 5, True)
    t = {n: torch.tensor(d[n], dtype=torch.float32).to(dtype)
         for n in NAMES + ('grad',)}
    t['masks'] = space_to_depth(t['masks'], 4).contiguous()
    leaves = [t[n].clone().requires_grad_() for n in NAMES]
    empty = torch.zeros((B, H, W, 0), dtype=dtype)
    out, _ = cdna_tail.fused_warp_composite_reference(
        leaves[0], leaves[1], empty, empty, leaves[2], leaves[3], True, 4)
    out.backward(t['grad'])
    explicit = cdna_tail.fused_warp_composite_backward_reference(
        t['grad'], *(t[n] for n in NAMES), sna=True, mask_block=4)
    tol = REL_TOL if dtype == torch.float32 else 1e-2
    for leaf, e in zip(leaves, explicit):
        assert e.dtype == dtype and e.shape == leaf.shape
        assert _rel_err(e.float().numpy(), leaf.grad.float().numpy()) <= tol


def test_backward_wrapper_on_the_cpu_takes_the_plain_version():
    """On a CPU tensor the wrapper returns the plain backward, ``None``
    where a gradient is not asked for, and launches nothing."""
    d = _inputs(12, 5, True)
    t = [torch.tensor(d[n], dtype=torch.float32) for n in ('grad',) + NAMES]
    before = cdna_tail.fused_warp_composite_backward.launches
    got = cdna_tail.fused_warp_composite_backward(
        *t, needs=(True, False, True, True))
    want = cdna_tail.fused_warp_composite_backward_reference(*t)
    assert cdna_tail.fused_warp_composite_backward.launches == before
    assert got[1] is None
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert torch.equal(g, w)
