"""Port parity: DNA's tail in ``ops/cdna_tail.py``
(``fused_warp_composite_dna``: the DNA head's logits and the softmax masks
given, the field made inside), against the JAX package.  Inputs come from
numpy with a fixed seed.

On the JAX side the field is made as ``visual_foresight_tpu/models/cdna.py``
:461-466 makes it (ReLU shift, normalisation over the taps, weighed by the
transform masks' total and cast to the compute type), then warped two ways:
by the Pallas ``fused_warp_composite_eff`` in interpret mode (which raises
``ZeroDivisionError`` there at P=0, so P=0 is held against the XLA tail
alone) and by the model's XLA tail, ``dna_warp`` plus compositing (:499-525).
The masks come in f32 (the classic backbone's softmax) or in the compute type
(the space-to-depth backbone's).

Tolerances: f32 1e-6 (the same arithmetic, summed in another order, on
outputs below 2); bf16 2e-2, as ``tests/test_torch_cdna_eff.py``'s bf16 case
(both sides round the [0, 1] outputs to bf16, whose ulp is 7.8e-3 near 1;
the XLA tail also accumulates in bf16, so bf16 is held against Pallas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_tpu.ops import cdna_warp as jwarp
from visual_foresight_tpu.ops.pallas_cdna import fused_warp_composite_eff
from visual_foresight_torch.ops import cdna_tail

F32_TOL = 1e-6
BF16_TOL = 2e-2
B, H, W, C, NUM_MASKS = 2, 12, 20, 3, 4
NAMES = ('prev', 'first', 'pd', 'fd', 'logits', 'masks')


def _inputs(seed, p, k, sna):
    """Frames and distributions in [0, 1]; DNA logits (some below zero, so
    the ReLU shift matters) and softmax masks over the background and
    ``NUM_MASKS`` transform channels."""
    rng = np.random.RandomState(seed)
    nc = NUM_MASKS + (2 if sna else 1)
    logits = rng.randn(B, H, W, nc).astype(np.float32) * 2.0
    return {
        'prev': rng.rand(B, H, W, C).astype(np.float32),
        'first': rng.rand(B, H, W, C).astype(np.float32),
        'pd': rng.rand(B, H, W, p).astype(np.float32),
        'fd': rng.rand(B, H, W, p).astype(np.float32),
        'logits': (rng.randn(B, H, W, k * k) * 0.5 + 0.3).astype(np.float32),
        'masks': np.exp(logits) / np.exp(logits).sum(-1, keepdims=True),
    }


def _jax_field(logits, masks, sna, dtype):
    """The field and the background masks as the JAX DNA step makes them
    (``models/cdna.py`` :461-466, then :498 for the masks)."""
    offset = 2 if sna else 1
    pk = jax.nn.relu(logits.astype(jnp.float32) - 1e-12) + 1e-12
    pk = pk / jnp.sum(pk, -1, keepdims=True)
    eff = (pk * jnp.sum(masks[..., offset:], -1, keepdims=True)).astype(dtype)
    return eff, masks.astype(dtype)


def _jax_pallas(d, sna, dtype, mask_dtype):
    j = {n: jnp.asarray(d[n], dtype) for n in NAMES[:5]}
    eff, masks_c = _jax_field(j['logits'], jnp.asarray(d['masks'], mask_dtype),
                              sna, dtype)
    bg = masks_c[..., :2 if sna else 1]
    return fused_warp_composite_eff(j['prev'], j['first'], j['pd'], j['fd'],
                                    eff, bg, sna=sna, block_b=B,
                                    interpret=True)


def _jax_xla_tail(d, sna, dtype):
    """The JAX model's XLA tail (``models/cdna.py`` :497-525)."""
    j = {n: jnp.asarray(d[n], dtype) for n in NAMES[:5]}
    eff, masks_c = _jax_field(j['logits'], jnp.asarray(d['masks']), sna,
                              dtype)
    img = j['prev'] * masks_c[..., 0:1]
    if sna:
        img = img + j['first'] * masks_c[..., 1:2]
    if not d['pd'].shape[-1]:
        return img + jwarp.dna_warp(j['prev'], eff), None
    warped = jwarp.dna_warp(jnp.concatenate([j['prev'], j['pd']], -1), eff)
    gd = j['pd'] * masks_c[..., 0:1]
    if sna:
        gd = gd + j['fd'] * masks_c[..., 1:2]
    return img + warped[..., :C], gd + warped[..., C:]


def _port(d, sna, dtype, mask_dtype=torch.float32):
    args = [torch.tensor(d[n]).to(dtype) for n in NAMES[:5]]
    args.append(torch.tensor(d['masks']).to(mask_dtype))
    before = cdna_tail.fused_warp_composite_dna.launches
    got = cdna_tail.fused_warp_composite_dna(*args, sna=sna)
    # a CPU tensor takes the plain version and launches nothing
    assert cdna_tail.fused_warp_composite_dna.launches == before
    want = cdna_tail.fused_warp_composite_dna_reference(*args, sna=sna)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    return got


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, 'max abs err {} > {}'.format(err, tol)


@pytest.mark.parametrize('p,sna,k', [
    (0, True, 5), (0, False, 3), (1, True, 5), (1, False, 7), (2, True, 3),
    (2, False, 5), (3, True, 7), (3, False, 3)])
def test_dna_plain_version_matches_jax_f32(p, sna, k):
    d = _inputs(p * 10 + k, p, k, sna)
    img, dist = _port(d, sna, torch.float32)
    want_img, want_dist = _jax_xla_tail(d, sna, jnp.float32)
    _close(img, want_img, F32_TOL)
    if p:
        _close(dist, want_dist, F32_TOL)
        want = _jax_pallas(d, sna, jnp.float32, jnp.float32)
        _close(img, want[0], F32_TOL)
        _close(dist, want[1], F32_TOL)
    else:
        assert tuple(dist.shape) == (B, H, W, 0)


@pytest.mark.parametrize('mask_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('p,sna,k', [(1, True, 5), (3, False, 3)])
def test_dna_plain_version_bf16_matches_pallas(p, sna, k, mask_dtype):
    """bf16 frames and logits; masks in f32 (the classic backbone) or bf16
    (the space-to-depth backbone), whose transform total is then rounded to
    bf16 before it weighs the field, on both sides."""
    d = _inputs(7 + k, p, k, sna)
    torch_mask = {'f32': torch.float32, 'bf16': torch.bfloat16}[mask_dtype]
    jax_mask = {'f32': jnp.float32, 'bf16': jnp.bfloat16}[mask_dtype]
    got = _port(d, sna, torch.bfloat16, torch_mask)
    want = _jax_pallas(d, sna, jnp.bfloat16, jax_mask)
    _close(got[0], want[0], BF16_TOL)
    _close(got[1], want[1], BF16_TOL)


def test_dna_entry_checks_and_dispatch():
    """The wrapper's checks, which run before any launch, called directly;
    a device that is neither the CPU nor CUDA raises."""
    d = _inputs(4, 1, 5, True)
    args = [torch.tensor(d[n]) for n in NAMES]
    cdna_tail._check_dna(*args, True)
    cdna_tail._check_dna(*args[:5], args[5][..., 1:].contiguous(), False)
    cdna_tail._check_dna(*(a.to(torch.bfloat16) for a in args[:5]),
                         args[5], True)
    cdna_tail._check_dna(*(a.to(torch.bfloat16) for a in args), True)
    with pytest.raises(ValueError, match='K\\*K'):
        cdna_tail._check_dna(*args[:4], args[4][..., :24].contiguous(),
                             args[5], True)
    with pytest.raises(ValueError, match='masks'):
        cdna_tail._check_dna(*args[:5], args[5][..., :2].contiguous(), True)
    with pytest.raises(ValueError, match='dna_logits has shape'):
        cdna_tail._check_dna(*args[:4], args[4][:, :8].contiguous(),
                             args[5], True)
    with pytest.raises(ValueError, match='masks has shape'):
        cdna_tail._check_dna(*args[:5], args[5][:, :8].contiguous(), True)
    with pytest.raises(ValueError, match='bfloat16'):
        cdna_tail._check_dna(*args[:4], args[4].to(torch.bfloat16), args[5],
                             True)
    with pytest.raises(ValueError, match='float32 or'):
        cdna_tail._check_dna(*args[:5], args[5].double(), True)
    with pytest.raises(ValueError, match='contiguous'):
        cdna_tail._check_dna(*args[:5], args[5].transpose(1, 2), True)
    with pytest.raises(ValueError, match='no hand-written kernel'):
        cdna_tail.fused_warp_composite_dna(*(a.to('meta') for a in args))
