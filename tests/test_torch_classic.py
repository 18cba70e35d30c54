"""Port parity: every architecture of ``visual_foresight_tpu/models/cdna.py``
that is not the space-to-depth CDNA model of
``tests/test_torch_cdna_model.py``, on seeded perturbed parameters:

- the flax-style transposed convolution (``models/layers.py``) against
  ``flax.linen.ConvTranspose``, at odd and even sizes;
- the classic Finn-CDNA backbone (``std_factor`` 0), one step, with dense
  and separable gates, SNA on and off, with and without the latent;
- ``encode_context`` + ``rollout_from`` and the teacher-forced ``forward``
  of the classic backbone, of DNA on both backbones, of ``fuse_decode`` and
  of ``s2d_tail`` (which the port runs through its full-resolution tail,
  held against JAX's block tail in f32), each against the JAX model with
  the same option.

Tolerances: the transposed convolution 1e-5 (one f32 sum on each side);
the models 1e-4, as ``tests/test_torch_cdna_model.py``'s small model (f32,
fifteen or more layers deep and several steps of recurrence, summation
orders differ between XLA and torch).  Latents are made with numpy from a
seed and given to both sides."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights_classic import few_torch_threads  # noqa: F401
from visual_foresight_tpu.models import cdna as jcdna
from visual_foresight_torch.models import cdna as tcdna
from visual_foresight_torch.models.convert import load_flax_params
from visual_foresight_torch.models.layers import ConvTranspose

CONV_TOL = 1e-5
TOL = 1e-4
H, W = 16, 24
CLASSIC = dict(num_distribs=1, std_factor=0, enc_features=(8, 16, 16),
               lstm_kernel=3, separable_lstm=True, num_masks=4,
               renorm_distribs=False)
STD = dict(CLASSIC, std_factor=4, mask_softmax='lowres')
LATENT = dict(latent_dim=4, sdim=5, adim=4)


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
    if isinstance(x, tuple):
        return tuple(_to_torch(y) for y in x)
    return None if x is None else torch.tensor(np.asarray(x))


@pytest.mark.parametrize('h,w,cin,cout', [(3, 5, 4, 6), (4, 4, 5, 5),
                                          (6, 7, 3, 2), (1, 2, 2, 3)])
def test_conv_transpose_matches_flax(h, w, cin, cout):
    """k=3, stride 2, SAME, as the classic decoder has it; also in == out,
    where a kernel laid out wrong would keep its shape."""
    x = np.random.RandomState(h * w).randn(2, h, w, cin).astype(np.float32)
    jm = fnn.ConvTranspose(cout, (3, 3), strides=(2, 2), padding='SAME')
    params = _perturbed(jm.init(jax.random.PRNGKey(0), x), 1, scale=0.3)
    want = np.asarray(jm.apply(params, x))
    tm = ConvTranspose(cin, cout)
    load_flax_params(tm, _np_tree(params))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(got, want, atol=CONV_TOL)


def _classic_carry(rng, b, f, kw):
    """A random step carry of the classic backbone (five LSTM states)."""
    f1, f2, f3 = f
    pair = lambda d, c: tuple(rng.randn(b, H // d, W // d, c).astype(
        np.float32) for _ in range(2))
    sdim = kw.get('sdim', 3)
    latent = rng.randn(b, 4).astype(np.float32) if kw.get('latent_dim') \
        else None
    return ((pair(2, f1), pair(4, f2), pair(8, f3), pair(4, f2),
             pair(2, f1)),
            rng.rand(b, H, W, 3).astype(np.float32),
            rng.rand(b, H, W, 1).astype(np.float32),
            rng.randn(b, sdim).astype(np.float32),
            rng.rand(b, H, W, 3).astype(np.float32),
            rng.rand(b, H, W, 1).astype(np.float32), latent)


@pytest.mark.parametrize('over', [
    dict(separable_lstm=True), dict(separable_lstm=False),
    dict(sna=False, renorm_distribs=True), dict(LATENT, lstm_kernel=5),
    dict(dna=True, separable_lstm=False)],
    ids=['separable', 'dense', 'no-sna-renorm', 'latent', 'dna-dense'])
def test_classic_step_matches_flax(over):
    rng = np.random.RandomState(1)
    b = 2
    kw = dict(CLASSIC, **over)
    carry = _classic_carry(rng, b, kw['enc_features'], kw)
    action = rng.randn(b, kw.get('adim', 3)).astype(np.float32)
    jkw = {k: v for k, v in kw.items() if k not in ('latent_dim', 'adim')}
    jstep = jcdna.CDNAStep(plan_mode=True, **jkw)
    params = _perturbed(jstep.init(jax.random.PRNGKey(0), carry, action), 2)
    jcarry, jouts = jstep.apply(params, carry, action)

    tstep = tcdna.CDNAStep((H, W), **kw)
    load_flax_params(tstep, _np_tree(params))
    with torch.no_grad():
        tcarry, touts = tstep(_to_torch(carry), torch.tensor(action))
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for got, want in zip(jax.tree.leaves(tcarry[0]),
                         jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# (id, model options): each runs encode_context + rollout_from and the
# teacher-forced forward against the JAX model with the same options
MODEL_CASES = [
    ('classic', CLASSIC),
    ('classic-dense-no-sna', dict(CLASSIC, separable_lstm=False, sna=False)),
    ('classic-latent', dict(CLASSIC, **LATENT)),
    ('classic-dna-no-sna-renorm', dict(CLASSIC, dna=True, sna=False,
                                       renorm_distribs=True)),
    ('std-dna-lowres', dict(STD, dna=True)),
    ('std-dna-fullres-latent', dict(STD, dna=True, mask_softmax='fullres',
                                    **LATENT)),
    ('std-fuse-decode', dict(STD, fuse_decode=True)),
    ('std-fuse-decode-dna-latent', dict(STD, fuse_decode=True, dna=True,
                                        **LATENT)),
    ('std-s2d-tail', dict(STD, s2d_tail=True)),
    ('std-s2d-tail-no-sna-renorm', dict(STD, s2d_tail=True, sna=False,
                                        renorm_distribs=True)),
    ('std-s2d-tail-frames-only', dict(STD, s2d_tail=True, num_distribs=0)),
]


def _models(kw, seed, steps):
    """The JAX and the port's model on the same perturbed parameters."""
    adim, sdim = kw.get('adim', 3), kw.get('sdim', 3)
    jm = jcdna.CDNAPredictor(**kw)
    p = kw['num_distribs']
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)),
                     jnp.zeros((1, steps, adim)), jnp.zeros((1, 2, sdim)),
                     jnp.zeros((1, 2, H, W, p)) if p else None)
    params = _perturbed(params, seed)
    tm = tcdna.CDNAPredictor((H, W), **kw)
    load_flax_params(tm, _np_tree(params))
    return jm, params, tm


def _batch(rng, kw, b, n_in, steps):
    adim, sdim, p = kw.get('adim', 3), kw.get('sdim', 3), kw['num_distribs']
    return dict(
        imgs=rng.rand(b, n_in, H, W, 3).astype(np.float32),
        states=(rng.randn(b, n_in, sdim) * 0.1).astype(np.float32),
        dists=rng.rand(b, n_in, H, W, p).astype(np.float32) if p else None,
        acts=(rng.randn(b, steps, adim) * 0.1).astype(np.float32),
        latent=rng.randn(b, 4).astype(np.float32)
        if kw.get('latent_dim') else None)


def _compare(got, want, kw):
    keys = ['gen_images', 'gen_states'] + \
        (['gen_distribs'] if kw['num_distribs'] else [])
    for key in keys:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, err_msg=key)


@pytest.mark.parametrize('case', MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_encode_and_rollout_match_flax(case):
    _, kw = case
    b, steps = 2, 3
    jm, params, tm = _models(kw, 3, steps)
    d = _batch(np.random.RandomState(4), kw, b, 2, steps)
    opt = lambda x, f: None if x is None else f(x)
    carry = jm.apply(params, d['imgs'], d['acts'][:, :1], d['states'],
                     d['dists'], method='encode_context')
    want = jm.apply(params, carry, d['acts'],
                    latent=opt(d['latent'], jnp.asarray),
                    method='rollout_from')
    with torch.no_grad():
        tcarry = tm.encode_context(torch.tensor(d['imgs']),
                                   torch.tensor(d['acts'][:, :1]),
                                   torch.tensor(d['states']),
                                   opt(d['dists'], torch.tensor))
        got = tm.rollout_from(tcarry, torch.tensor(d['acts']),
                              latent=opt(d['latent'], torch.tensor))
    _compare(got, want, kw)
    assert tuple(got['gen_images_tm'].shape) == (steps, b, H, W, 3)


FORWARD_CASES = [c for c in MODEL_CASES if c[0] in (
    'classic-dense-no-sna', 'classic-latent', 'classic-dna-no-sna-renorm',
    'std-dna-fullres-latent', 'std-fuse-decode-dna-latent')]


@pytest.mark.parametrize('case', FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_teacher_forced_forward_matches_flax(case):
    """A per-sample schedule over a trajectory (the first column forced to
    1), on each backbone with DNA, a latent and ``fuse_decode`` among the
    cases; ``s2d_tail`` is plan-mode only, so the forward never takes
    it."""
    _, kw = case
    b, steps = 2, 4
    jm, params, tm = _models(kw, 5, steps)
    rng = np.random.RandomState(6)
    d = _batch(rng, kw, b, steps + 1, steps)
    gt_mask = (rng.rand(b, steps) < 0.5).astype(np.float32)
    opt = lambda x, f: None if x is None else f(x)
    want = jm.apply(params, d['imgs'], d['acts'], d['states'], d['dists'],
                    gt_mask=jnp.asarray(gt_mask),
                    latent=opt(d['latent'], jnp.asarray))
    with torch.no_grad():
        got = tm(torch.tensor(d['imgs']), torch.tensor(d['acts']),
                 torch.tensor(d['states']), opt(d['dists'], torch.tensor),
                 gt_mask=torch.tensor(gt_mask),
                 latent=opt(d['latent'], torch.tensor))
    _compare(got, want, kw)


@pytest.mark.parametrize('kw,tail,blocks', [
    (CLASSIC, 'folded', 0), (dict(CLASSIC, dna=True), 'dna', 0),
    (dict(STD, dna=True), 'dna', 0), (STD, 'folded', 4),
    (dict(STD, s2d_tail=True), 'folded', 4)],
    ids=['classic', 'classic-dna', 'std-dna', 'std', 'std-s2d-tail'])
def test_each_architecture_takes_its_tail(kw, tail, blocks, monkeypatch):
    """CDNA runs the folded tail (full-resolution masks on the classic
    backbone), DNA the DNA mode with the full-resolution logits and masks
    (f32 on the classic backbone, the compute type on the space-to-depth
    one); ``s2d_tail`` takes the same tail as without it."""
    seen = []
    for name in ('fused_warp_composite', 'fused_warp_composite_dna'):
        fn = getattr(tcdna, name)
        monkeypatch.setattr(
            tcdna, name, lambda *a, _f=fn, _n=name, **k: seen.append(
                (_n, tuple(a[4].shape), tuple(a[5].shape), a[5].dtype,
                 k.get('mask_block'))) or _f(*a, **k))
    tm = tcdna.CDNAPredictor((H, W), **kw)
    gen = torch.Generator().manual_seed(0)
    b, nc = 2, 4 + (2 if kw.get('sna', True) else 1)
    with torch.no_grad():
        carry = tm.encode_context(torch.rand((b, 2, H, W, 3), generator=gen),
                                  torch.zeros((b, 1, 3)),
                                  torch.zeros((b, 2, 3)),
                                  torch.rand((b, 2, H, W, 1), generator=gen))
        n_context = len(seen)
        tm.rollout_from(carry, torch.zeros((b, 2, 3)))
    if tail == 'dna':
        want = ('fused_warp_composite_dna', (b, H, W, 25), (b, H, W, nc),
                torch.float32, None)
    elif blocks:
        want = ('fused_warp_composite', (b, 5, 5, 4),
                (b, H // blocks, W // blocks, blocks * blocks * nc),
                torch.float32, blocks)
    else:
        want = ('fused_warp_composite', (b, 5, 5, 4), (b, H, W, nc),
                torch.float32, 0)
    assert n_context == 1 and seen == [want] * 3


def test_fuse_decode_composes_once_per_rollout(monkeypatch):
    """The composed decode weights are made once per ``rollout_from`` (and
    once per ``encode_context``), never per step."""
    tm = tcdna.CDNAPredictor((H, W), **dict(STD, fuse_decode=True))
    calls = []
    compose = tm.step.compose_decode
    monkeypatch.setattr(tm.step, 'compose_decode',
                        lambda: calls.append(1) or compose())
    with torch.no_grad():
        carry = tm.encode_context(torch.rand((1, 2, H, W, 3)),
                                  torch.zeros((1, 1, 3)),
                                  torch.zeros((1, 2, 3)),
                                  torch.rand((1, 2, H, W, 1)))
        tm.rollout_from(carry, torch.zeros((1, 5, 3)))
    assert len(calls) == 2


def test_fuse_decode_step_needs_the_composed_weights():
    """A step under ``fuse_decode`` never composes its own weights."""
    tm = tcdna.CDNAPredictor((H, W), **dict(STD, fuse_decode=True))
    with torch.no_grad():
        carry = tm.encode_context(torch.rand((1, 2, H, W, 3)),
                                  torch.zeros((1, 1, 3)),
                                  torch.zeros((1, 2, 3)),
                                  torch.rand((1, 2, H, W, 1)))
        with pytest.raises(ValueError, match='compose_decode'):
            tm.step(carry, torch.zeros((1, 3)))
        _, (img, _, _) = tm.step(carry, torch.zeros((1, 3)),
                                 decode=tm.step.compose_decode())
    assert tuple(img.shape) == (1, H, W, 3)


def test_classic_is_the_default_and_std_needs_its_divisor():
    tm = tcdna.CDNAPredictor((48, 64), num_distribs=1)
    assert tm.std_factor == 0 and hasattr(tm.step, 'lstm5')
    assert tm.step.cdna_head.in_features == 6 * 8 * 128     # h3 at H/8
    with pytest.raises(ValueError, match='divide 8'):
        tcdna.CDNAPredictor((20, 24))
    with pytest.raises(ValueError, match='divide 8'):
        tcdna.CDNAPredictor((16, 20), std_factor=4)
