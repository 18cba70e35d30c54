"""Port parity: ``visual_foresight_torch.models.cdna`` against the flax
CDNA predictor, on the space-to-depth backbone.

Tolerances: small model 1e-4 (f32, 15 layers deep and several steps of
recurrence, summation order differs between XLA and torch); the vendored
checkpoints (xz_flagship, and ag_r5f_v2 with its latent) at full width 1e-3
(the same, at 128-256 channels, whose longer sums lose more bits).  Latents
are made with numpy from a seed and given to both sides."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
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


def _to_torch(x):
    """A carry of numpy arrays (nested tuples, ``None`` for no latent)."""
    if isinstance(x, tuple):
        return tuple(_to_torch(y) for y in x)
    return None if x is None else torch.tensor(x)


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
    with torch.no_grad():
        tcarry, touts = tstep(_to_torch(carry), torch.tensor(action))
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
    with torch.no_grad():
        _, touts = tstep(_to_torch(carry), torch.tensor(action))
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


LATENT = dict(SMALL, latent_dim=4, sdim=5, adim=4)


def _latent_batch(rng, b, h, w, n_in, steps):
    """Seeded images, states, distributions, actions and latent of a small
    latent model (sdim 5, adim 4, as ag_r5f_v2 has them)."""
    return dict(
        imgs=rng.rand(b, n_in, h, w, 3).astype(np.float32),
        states=(rng.randn(b, n_in, 5) * 0.1).astype(np.float32),
        dists=rng.rand(b, n_in, h, w, 1).astype(np.float32),
        acts=(rng.randn(b, steps, 4) * 0.1).astype(np.float32),
        latent=rng.randn(b, 4).astype(np.float32))


def _latent_models(h, w, steps, seed, **over):
    kw = dict(LATENT, **over)
    jm = jcdna.CDNAPredictor(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, h, w, 3)),
                     jnp.zeros((1, steps, 4)), jnp.zeros((1, 2, 5)),
                     jnp.zeros((1, 2, h, w, 1)))
    params = _perturbed(params, seed)
    tm = tcdna.CDNAPredictor((h, w), **kw)
    load_flax_params(tm, _np_tree(params))
    return jm, params, tm


def test_latent_step_matches_flax():
    """One plan-mode step with the latent in the carry: ``cond_proj`` takes
    state, action and latent; ``state_head`` state and action alone."""
    rng = np.random.RandomState(11)
    b, h, w, f1, f2 = 2, 16, 24, 8, 16
    kw = dict(SMALL, plan_mode=True, sdim=5)
    jstep = jcdna.CDNAStep(**kw)
    pair = lambda hh, ww, f: tuple(
        rng.randn(b, hh, ww, f).astype(np.float32) for _ in range(2))
    carry = ((pair(h // 4, w // 4, f1), pair(h // 8, w // 8, f2),
              pair(h // 4, w // 4, f1)),
             rng.rand(b, h, w, 3).astype(np.float32),
             rng.rand(b, h, w, 1).astype(np.float32),
             rng.randn(b, 5).astype(np.float32),
             rng.rand(b, h, w, 3).astype(np.float32),
             rng.rand(b, h, w, 1).astype(np.float32),
             rng.randn(b, 4).astype(np.float32))
    action = rng.randn(b, 4).astype(np.float32)
    params = _perturbed(jstep.init(jax.random.PRNGKey(0), carry, action), 12)
    assert params['params']['cond_proj']['kernel'].shape[0] == 5 + 4 + 4
    assert params['params']['state_head']['kernel'].shape[0] == 5 + 4
    jcarry, jouts = jstep.apply(params, carry, action)

    kw.pop('plan_mode')
    tstep = tcdna.CDNAStep((h, w), adim=4, latent_dim=4, **kw)
    load_flax_params(tstep, _np_tree(params))
    with torch.no_grad():
        tcarry, touts = tstep(_to_torch(carry), torch.tensor(action))
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SMALL_TOL)
    np.testing.assert_array_equal(tcarry[6].numpy(), carry[6])
    # a carry without the latent is refused, not silently zero-filled
    with pytest.raises(ValueError, match='latent'):
        tstep(_to_torch(carry[:6] + (None,)), torch.tensor(action))


@pytest.mark.parametrize('inject', ['latent', 'zeros'])
def test_latent_encode_and_rollout_match_flax(inject):
    """``encode_context`` under a zero latent, then ``rollout_from`` under a
    given one (or, with neither latent nor generator, the carry's zeros)."""
    rng = np.random.RandomState(13)
    b, h, w, steps = 3, 16, 24, 4
    d = _latent_batch(rng, b, h, w, 2, steps)
    jm, params, tm = _latent_models(h, w, steps, 14)
    latent = d['latent'] if inject == 'latent' else None
    carry = jm.apply(params, d['imgs'], d['acts'][:, :1], d['states'],
                     d['dists'], method='encode_context')
    np.testing.assert_array_equal(np.asarray(carry[6]), np.zeros((b, 4)))
    want = jm.apply(params, carry, d['acts'], latent=None if latent is None
                    else jnp.asarray(latent), method='rollout_from')
    with torch.no_grad():
        tcarry = tm.encode_context(
            torch.tensor(d['imgs']), torch.tensor(d['acts'][:, :1]),
            torch.tensor(d['states']), torch.tensor(d['dists']))
        assert torch.equal(tcarry[6], torch.zeros((b, 4)))
        got = tm.rollout_from(tcarry, torch.tensor(d['acts']),
                              latent=None if latent is None
                              else torch.tensor(latent))
    for key in ('gen_images', 'gen_states', 'gen_distribs'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=SMALL_TOL, err_msg=key)


def test_rollout_draws_one_latent_per_sample_from_the_generator():
    b, h, w = 3, 16, 24
    _, _, tm = _latent_models(h, w, 2, 15)
    d = _latent_batch(np.random.RandomState(16), b, h, w, 2, 2)
    args = [torch.tensor(d[k]) for k in ('imgs', 'acts', 'states', 'dists')]
    with torch.no_grad():
        carry = tm.encode_context(args[0], args[1][:, :1], *args[2:])
        drawn = tm.rollout_from(carry, args[1],
                                generator=torch.Generator().manual_seed(5))
        latent = torch.randn((b, 4), generator=torch.Generator().manual_seed(5))
        given = tm.rollout_from(carry, args[1], latent=latent)
        zeros = tm.rollout_from(carry, args[1])
    assert torch.equal(drawn['gen_images'], given['gen_images'])
    assert not torch.equal(drawn['gen_images'], zeros['gen_images'])
    one = (carry[1][:1], carry[6][:1], None)
    wide = tcdna.broadcast_carry(one, 5)
    assert wide[0].shape == (5, h, w, 3) and wide[1].shape == (5, 4)
    assert wide[2] is None


@pytest.mark.parametrize('case', ['gt_mask', 'default_mask', 'padded',
                                  'zeros_latent', 'no_latent_model'])
def test_teacher_forced_forward_matches_flax(case):
    """``CDNAPredictor.forward`` against flax's ``__call__``: a per-sample
    ``gt_mask`` over a full trajectory (its first column is forced to 1),
    the default schedule, ground truth shorter than the actions (padded with
    zeros and masked off), no latent given and no generator (zeros), and a
    model without a latent."""
    rng = np.random.RandomState(17)
    b, h, w, steps = 2, 16, 24, 5
    n_in = 3 if case == 'padded' else (steps + 1 if case == 'gt_mask' else 2)
    d = _latent_batch(rng, b, h, w, n_in, steps)
    over = {'latent_dim': 0} if case == 'no_latent_model' else {}
    jm, params, tm = _latent_models(h, w, steps, 18, **over)
    gt_mask = None
    if case == 'gt_mask':
        gt_mask = (rng.rand(b, steps) < 0.5).astype(np.float32)
        gt_mask[:, 0] = 0.0
    elif case == 'padded':
        gt_mask = np.array([1, 1, 0, 1, 0], np.float32)[:steps]
        gt_mask[3] = 0.0
    latent = None if case in ('zeros_latent', 'no_latent_model') \
        else d['latent']
    opt = lambda x: None if x is None else jnp.asarray(x)
    want = jm.apply(params, d['imgs'], d['acts'], d['states'], d['dists'],
                    gt_mask=opt(gt_mask), latent=opt(latent))
    opt = lambda x: None if x is None else torch.tensor(x)
    with torch.no_grad():
        got = tm(torch.tensor(d['imgs']), torch.tensor(d['acts']),
                 torch.tensor(d['states']), torch.tensor(d['dists']),
                 gt_mask=opt(gt_mask), latent=opt(latent))
    for key in ('gen_images', 'gen_states', 'gen_distribs'):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=SMALL_TOL, err_msg=key)


def test_forward_draws_its_latent_from_the_generator():
    b, h, w = 2, 16, 24
    _, _, tm = _latent_models(h, w, 3, 19)
    d = _latent_batch(np.random.RandomState(20), b, h, w, 2, 3)
    args = [torch.tensor(d[k]) for k in ('imgs', 'acts', 'states', 'dists')]
    with torch.no_grad():
        drawn = tm(*args, generator=torch.Generator().manual_seed(7))
        latent = torch.randn((b, 4), generator=torch.Generator().manual_seed(7))
        given = tm(*args, latent=latent)
    assert torch.equal(drawn['gen_images'], given['gen_images'])


def test_vendored_ag_r5f_v2_full_width_matches_flax():
    """The vendored ag_r5f_v2 checkpoint (latent_dim 8, adim 4, sdim 5),
    restored by JAX and carried over by ``params_from_flax``: batch 2, the
    context step under zeros, one plan step under a given latent, f32."""
    from visual_foresight_tpu.prediction.predictor import TPUPredictor
    model_dir = os.path.join(REPO, 'benchmarks', 'models', 'ag_r5f_v2')
    jp = TPUPredictor(model_dir, {'designated_pixel_count': 1,
                                  'img_dims': (48, 64),
                                  'dtype': 'float32'}).restore()
    assert jp.restored
    tree = _np_tree(jp.params[0])
    assert tree['params']['step']['cond_proj']['kernel'].shape[0] == 17
    rng = np.random.RandomState(21)
    b, h, w = 2, 48, 64
    imgs = rng.rand(b, 2, h, w, 3).astype(np.float32)
    acts = (rng.randn(b, 1, 4) * 0.05).astype(np.float32)
    states = (rng.randn(b, 2, 5) * 0.05).astype(np.float32)
    dists = np.zeros((b, 2, h, w, 1), np.float32)
    dists[:, :, 24, 32, 0] = 1.0
    latent = rng.randn(b, 8).astype(np.float32)
    carry = jp.model.apply(jp.params[0], imgs, acts, states, dists,
                           method='encode_context')
    want = jp.model.apply(jp.params[0], carry, acts,
                          latent=jnp.asarray(latent), method='rollout_from')

    tm = tcdna.CDNAPredictor((h, w), num_distribs=1, std_factor=4,
                             enc_features=(128, 256, 256), lstm_kernel=3,
                             separable_lstm=True, renorm_distribs=False,
                             sdim=5, adim=4, latent_dim=8)
    load_flax_params(tm, tree)
    with torch.no_grad():
        tcarry = tm.encode_context(torch.tensor(imgs), torch.tensor(acts),
                                   torch.tensor(states), torch.tensor(dists))
        got = tm.rollout_from(tcarry, torch.tensor(acts),
                              latent=torch.tensor(latent))
    for key in ('gen_images', 'gen_states', 'gen_distribs'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=FLAGSHIP_TOL, err_msg=key)
