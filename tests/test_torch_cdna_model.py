"""Port parity: ``visual_foresight_torch.models.cdna`` against the flax
CDNA predictor, on the space-to-depth backbone.

Tolerances: small model 1e-4 (f32, 15 layers deep and several steps of
recurrence, summation order differs between XLA and torch); vendored
flagship at full width 1e-3 (the same, at 128-256 channels, whose longer
sums lose more bits)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.models import cdna as jcdna
from visual_foresight_torch.models import cdna as tcdna
from visual_foresight_torch.models.convert import load_flax_params

SMALL_TOL = 1e-4
FLAGSHIP_TOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_distribs=1, std_factor=4, enc_features=(8, 16, 16),
             lstm_kernel=3, separable_lstm=True, renorm_distribs=False)


def _perturbed(params, seed, scale=0.1):
    """Add seeded noise so every bias and LayerNorm parameter is non-zero."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale)
        for x in leaves])


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def test_space_to_depth_round_trip_matches_jax():
    x = np.random.RandomState(0).rand(2, 8, 12, 3).astype(np.float32)
    want = np.asarray(jcdna.space_to_depth(jnp.asarray(x), 4))
    got = tcdna.space_to_depth(torch.tensor(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcdna.depth_to_space(got, 4).numpy(),
        np.asarray(jcdna.depth_to_space(jnp.asarray(want), 4)))
    np.testing.assert_array_equal(tcdna.depth_to_space(got, 4).numpy(), x)


@pytest.mark.parametrize('sna,renorm', [(True, False), (False, True)])
def test_single_step_matches_flax(sna, renorm):
    rng = np.random.RandomState(1)
    b, h, w, f1, f2 = 2, 16, 32, 8, 16
    kw = dict(SMALL, sna=sna, renorm_distribs=renorm, plan_mode=True,
              mask_softmax='fullres')
    jstep = jcdna.CDNAStep(**kw)
    carry = (
        (tuple(rng.randn(b, h // 4, w // 4, f1).astype(np.float32)
               for _ in range(2)),
         tuple(rng.randn(b, h // 8, w // 8, f2).astype(np.float32)
               for _ in range(2)),
         tuple(rng.randn(b, h // 4, w // 4, f1).astype(np.float32)
               for _ in range(2))),
        rng.rand(b, h, w, 3).astype(np.float32),
        rng.rand(b, h, w, 1).astype(np.float32),
        rng.randn(b, 3).astype(np.float32),
        rng.rand(b, h, w, 3).astype(np.float32),
        rng.rand(b, h, w, 1).astype(np.float32),
        None)
    action = rng.randn(b, 3).astype(np.float32)
    params = _perturbed(jstep.init(jax.random.PRNGKey(0), carry, action), 2)
    jcarry, jouts = jstep.apply(params, carry, action)

    kw.pop('plan_mode')
    tstep = tcdna.CDNAStep((h, w), **kw)
    load_flax_params(tstep, _np_tree(params))
    to_t = lambda x: tuple(to_t(y) for y in x) if isinstance(x, tuple) \
        else torch.tensor(x)
    with torch.no_grad():
        tcarry, touts = tstep(to_t(carry[:-1]), torch.tensor(action))
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SMALL_TOL)
    for got, want in zip(jax.tree.leaves(tcarry[0]),
                         jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SMALL_TOL)


@pytest.mark.parametrize('sna', [True, False])
def test_single_step_lowres_hands_the_tail_blocked_masks(sna, monkeypatch):
    """With the low-resolution mask softmax the step passes the masks as the
    mask head leaves them, (B, H/r, W/r, r*r*nc) with ``mask_block=r`` (no
    ``depth_to_space`` copy), and still matches the flax step."""
    rng = np.random.RandomState(6)
    b, h, w, f1, f2, r = 2, 16, 32, 8, 16, 4
    kw = dict(SMALL, sna=sna, plan_mode=True, mask_softmax='lowres')
    jstep = jcdna.CDNAStep(**kw)
    pair = lambda hh, ww, f: tuple(
        rng.randn(b, hh, ww, f).astype(np.float32) for _ in range(2))
    carry = ((pair(h // 4, w // 4, f1), pair(h // 8, w // 8, f2),
              pair(h // 4, w // 4, f1)),
             rng.rand(b, h, w, 3).astype(np.float32),
             rng.rand(b, h, w, 1).astype(np.float32),
             rng.randn(b, 3).astype(np.float32),
             rng.rand(b, h, w, 3).astype(np.float32),
             rng.rand(b, h, w, 1).astype(np.float32), None)
    action = rng.randn(b, 3).astype(np.float32)
    params = _perturbed(jstep.init(jax.random.PRNGKey(0), carry, action), 7)
    _, jouts = jstep.apply(params, carry, action)

    kw.pop('plan_mode')
    tstep = tcdna.CDNAStep((h, w), **kw)
    load_flax_params(tstep, _np_tree(params))
    seen = []
    tail = tcdna.fused_warp_composite

    def spy(*args, **kwargs):
        seen.append((tuple(args[5].shape), kwargs))
        return tail(*args, **kwargs)

    monkeypatch.setattr(tcdna, 'fused_warp_composite', spy)
    to_t = lambda x: tuple(to_t(y) for y in x) if isinstance(x, tuple) \
        else torch.tensor(x)
    with torch.no_grad():
        _, touts = tstep(to_t(carry[:-1]), torch.tensor(action))
    nc = SMALL.get('num_masks', 10) + (2 if sna else 1)
    assert seen == [((b, h // r, w // r, r * r * nc),
                     {'sna': sna, 'mask_block': r})]
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SMALL_TOL)


def test_fullres_step_hands_the_tail_full_resolution_masks(monkeypatch):
    b, h, w = 1, 16, 32
    tstep = tcdna.CDNAStep((h, w), **dict(SMALL, mask_softmax='fullres'))
    seen = []
    tail = tcdna.fused_warp_composite
    monkeypatch.setattr(
        tcdna, 'fused_warp_composite',
        lambda *a, **k: seen.append((tuple(a[5].shape), k['mask_block']))
        or tail(*a, **k))
    tm = tcdna.CDNAPredictor((h, w), **dict(SMALL, mask_softmax='fullres'))
    tm.step = tstep
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        carry = tm.encode_context(torch.rand((b, 2, h, w, 3), generator=gen),
                                  torch.zeros((b, 1, 3)),
                                  torch.zeros((b, 2, 3)),
                                  torch.rand((b, 2, h, w, 1), generator=gen))
        tm.rollout_from(carry, torch.zeros((b, 1, 3)))
    assert seen == [((b, h, w, 12), 0)] * 2


@pytest.mark.parametrize('mask_softmax', ['fullres', 'lowres'])
def test_encode_and_rollout_match_flax(mask_softmax):
    rng = np.random.RandomState(3)
    b, h, w, steps = 3, 16, 32, 4
    kw = dict(SMALL, mask_softmax=mask_softmax)
    imgs = rng.rand(b, 2, h, w, 3).astype(np.float32)
    acts = (rng.randn(b, 1, 3) * 0.1).astype(np.float32)
    states = (rng.randn(b, 2, 3) * 0.1).astype(np.float32)
    dists = rng.rand(b, 2, h, w, 1).astype(np.float32)
    plan = (rng.randn(b, steps, 3) * 0.1).astype(np.float32)
    jm = jcdna.CDNAPredictor(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, h, w, 3)),
                     jnp.zeros((1, steps, 3)), jnp.zeros((1, 2, 3)),
                     jnp.zeros((1, 2, h, w, 1)))
    params = _perturbed(params, 4)
    carry = jm.apply(params, imgs, acts, states, dists,
                     method='encode_context')
    want = jm.apply(params, carry, plan, method='rollout_from')

    tm = tcdna.CDNAPredictor((h, w), **kw)
    load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        tcarry = tm.encode_context(torch.tensor(imgs), torch.tensor(acts),
                                   torch.tensor(states), torch.tensor(dists))
        got = tm.rollout_from(tcarry, torch.tensor(plan))
    for key in ('gen_images', 'gen_states', 'gen_distribs'):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=SMALL_TOL, err_msg=key)


def test_vendored_flagship_full_width_matches_flax():
    """The vendored xz_flagship checkpoint, restored by JAX, carried over by
    ``params_from_flax``: batch 2, three plan steps, f32."""
    from visual_foresight_tpu.prediction.predictor import TPUPredictor
    model_dir = os.path.join(REPO, 'benchmarks', 'models', 'xz_flagship')
    hp = {'designated_pixel_count': 1, 'sequence_length': 17,
          'img_dims': (48, 64), 'dtype': 'float32', 'std_factor': 4,
          'enc_features': (128, 256, 256), 'separable_lstm': True,
          'lstm_kernel': 3}
    jp = TPUPredictor(model_dir, hp).restore()
    assert jp.restored
    rng = np.random.RandomState(5)
    b, h, w = 2, 48, 64
    imgs = rng.rand(b, 2, h, w, 3).astype(np.float32)
    acts = np.zeros((b, 1, 3), np.float32)
    states = (rng.randn(b, 2, 3) * 0.05).astype(np.float32)
    dists = np.zeros((b, 2, h, w, 1), np.float32)
    dists[:, :, 24, 32, 0] = 1.0
    plan = (rng.randn(b, 3, 3) * 0.05).astype(np.float32)
    carry = jp.model.apply(jp.params[0], imgs, acts, states, dists,
                           method='encode_context')
    want = jp.model.apply(jp.params[0], carry, plan, method='rollout_from')

    tm = tcdna.CDNAPredictor((h, w), num_distribs=1, std_factor=4,
                             enc_features=(128, 256, 256), lstm_kernel=3,
                             separable_lstm=True, renorm_distribs=False,
                             mask_softmax='fullres')
    load_flax_params(tm, _np_tree(jp.params[0]))
    with torch.no_grad():
        tcarry = tm.encode_context(torch.tensor(imgs), torch.tensor(acts),
                                   torch.tensor(states), torch.tensor(dists))
        got = tm.rollout_from(tcarry, torch.tensor(plan))
    for key in ('gen_images', 'gen_states', 'gen_distribs'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=FLAGSHIP_TOL, err_msg=key)
