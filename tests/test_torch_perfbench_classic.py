"""The benchmark's classic configuration tied to the JAX package.

- ``benchmarks/models/classic_cdna/model_config.json``, the published file
  that ``perfbench/configs/classic_cdna.json`` copies, holds the JAX
  package's ``DEFAULT_HPARAMS`` key for key, and the JAX model built at
  those defaults with one designated pixel has the parameter count that
  ``perfbench/archs/classic_cdna.py`` publishes;
- the plain reference of the classic backbone
  (``perfbench/reference/classic.py``), which imports nothing of either
  package, against the JAX package's classic model on the same seeded
  perturbed weights at a small size in f32: one step, the context encode
  and a rollout.

Tolerance 1e-4 of f32, as ``tests/test_torch_classic.py`` holds the port's
classic model to JAX: fifteen or more layers deep and several steps of
recurrence, in f32 on both sides, with sums taken in another order by XLA
and by torch (the reference's transposed convolutions are correlations of
a dilated input, the port's and XLA's are not)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench.archs import classic_cdna
from perfbench.reference.classic import Reference, param_specs
from test_torch_weights_classic import few_torch_threads  # noqa: F401
from visual_foresight_tpu.models import cdna as jcdna
from visual_foresight_tpu.prediction.predictor import (DEFAULT_HPARAMS,
                                                       TPUPredictor)
from visual_foresight_torch.models import cdna as tcdna
from visual_foresight_torch.models.convert import load_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
H, W = 16, 24
SMALL = dict(num_distribs=1, std_factor=0, enc_features=(8, 16, 32),
             lstm_kernel=3, separable_lstm=True, num_masks=4, kernel_size=3,
             renorm_distribs=False)
CASES = [
    ('published-form', {}),
    ('latent', dict(latent_dim=2, sdim=5, adim=4)),
    ('no-sna-renorm', dict(sna=False, renorm_distribs=True)),
]


def _published():
    with open(os.path.join(ROOT, classic_cdna.PUBLISHED_CONFIG)) as f:
        return json.load(f)


def test_published_config_is_the_jax_defaults():
    published = _published()
    assert published
    for key, value in published.items():
        want = DEFAULT_HPARAMS[key]
        assert value == (list(want) if isinstance(want, tuple) else want), \
            key
    with open(os.path.join(ROOT, 'perfbench', 'configs',
                           'classic_cdna.json')) as f:
        cfg = json.load(f)
    for key, value in published.items():
        assert cfg[key] == value, key


def test_published_params_are_the_jax_models():
    """The JAX model as ``TPUPredictor`` builds it at ``DEFAULT_HPARAMS``
    with one designated pixel, initialised abstractly; the table of
    weights that the benchmark makes adds up to the same count."""
    predictor = TPUPredictor(None, {'designated_pixel_count': 1})
    shapes = jax.eval_shape(predictor._init_params)
    count = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert count == classic_cdna.PUBLISHED_PARAMS
    specs = param_specs(_published())
    assert sum(math.prod(s[0]) for s in specs.values()) == count


def _cfg(kw):
    """The reference's configuration of the model options ``kw``."""
    return {'enc_features': list(kw['enc_features']), 'img_dims': [H, W],
            'kernel_size': kw['kernel_size'], 'num_masks': kw['num_masks'],
            'lstm_kernel': kw['lstm_kernel'], 'sna': kw.get('sna', True),
            'dna': False, 'separable_lstm': True, 'std_factor': 0,
            'sdim': kw.get('sdim', 3), 'adim': kw.get('adim', 3),
            'latent_dim': kw.get('latent_dim', 0), 'dtype': 'float32',
            'renorm_distribs': kw['renorm_distribs']}


def _perturbed(params, seed, scale=0.1):
    """Seeded noise on every leaf, so that no bias or LayerNorm parameter
    is at its initial value."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale)
        for x in leaves])


def _weights(module, params, prefix=''):
    """The flax tree ``params`` under the port's names (the converter of
    the port places each flax leaf; the reference reads them by name)."""
    load_flax_params(module, jax.tree.map(np.asarray, params))
    return {prefix + n: t.clone() for n, t in module.state_dict().items()}


def _jax_kw(kw):
    return {k: v for k, v in kw.items() if k not in ('latent_dim', 'adim')}


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_reference_step_matches_jax(case):
    kw = dict(SMALL, **case[1])
    cfg = _cfg(kw)
    f1, f2, f3 = kw['enc_features']
    rng = np.random.RandomState(1)
    b = 3
    pair = lambda d, c: tuple(rng.randn(b, H // d, W // d, c).astype(
        np.float32) for _ in range(2))
    states = (pair(2, f1), pair(4, f2), pair(8, f3), pair(4, f2),
              pair(2, f1))
    prev, first = (rng.rand(b, H, W, 3).astype(np.float32)
                   for _ in range(2))
    prev_d, first_d = (rng.rand(b, H, W, 1).astype(np.float32)
                       for _ in range(2))
    state = rng.randn(b, cfg['sdim']).astype(np.float32)
    latent = rng.randn(b, cfg['latent_dim']).astype(np.float32) \
        if cfg['latent_dim'] else None
    action = rng.randn(b, cfg['adim']).astype(np.float32)
    carry = (states, prev, prev_d, state, first, first_d, latent)
    jstep = jcdna.CDNAStep(plan_mode=True, **_jax_kw(kw))
    params = _perturbed(jstep.init(jax.random.PRNGKey(0), carry, action), 2)
    jcarry, (jimg, jdist, jstate) = jstep.apply(params, carry, action)

    weights = _weights(tcdna.CDNAStep((H, W), **kw), params, 'step.')
    ref = Reference(cfg, weights, 1, torch.device('cpu'))
    t = lambda x: torch.tensor(np.asarray(x))
    rcarry = (tuple((t(c), t(h)) for c, h in states),
              torch.cat([t(prev), t(prev_d)], dim=-1),
              torch.cat([t(first), t(first_d)], dim=-1), t(state))
    (rstates, out, _, rstate) = ref.step(
        rcarry, t(action), None if latent is None else t(latent))
    np.testing.assert_allclose(out[..., :3].numpy(), np.asarray(jimg),
                               atol=TOL)
    np.testing.assert_allclose(out[..., 3:].numpy(), np.asarray(jdist),
                               atol=TOL)
    np.testing.assert_allclose(rstate.numpy(), np.asarray(jstate), atol=TOL)
    for got, want in zip(jax.tree.leaves(rstates),
                         jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_reference_encode_and_rollout_match_jax(case):
    """The context encode at batch 1 and a rollout of 4 plans over 3
    steps from it, with the latent given to both sides."""
    kw = dict(SMALL, **case[1])
    cfg = _cfg(kw)
    b, steps = 4, 3
    jm = jcdna.CDNAPredictor(**kw)
    rng = np.random.RandomState(4)
    images = rng.rand(1, 2, H, W, 3).astype(np.float32)
    distribs = rng.rand(1, 2, H, W, 1).astype(np.float32)
    states = (0.1 * rng.randn(1, 2, cfg['sdim'])).astype(np.float32)
    ctx_actions = (0.1 * rng.randn(1, 1, cfg['adim'])).astype(np.float32)
    plans = (0.1 * rng.randn(b, steps, cfg['adim'])).astype(np.float32)
    latents = rng.randn(b, cfg['latent_dim']).astype(np.float32) \
        if cfg['latent_dim'] else None
    params = _perturbed(jm.init(jax.random.PRNGKey(0), images, plans[:1],
                                states, distribs), 3)
    jcarry = jm.apply(params, images, ctx_actions, states, distribs,
                      method='encode_context')
    wide = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape[1:]),
                        jcarry)
    want = jm.apply(params, wide, plans,
                    latent=None if latents is None else jnp.asarray(latents),
                    method='rollout_from')['gen_distribs']

    weights = _weights(tcdna.CDNAPredictor((H, W), **kw), params)
    ref = Reference(cfg, weights, 1, torch.device('cpu'))
    t = lambda x: torch.tensor(np.asarray(x))
    carry = ref.encode(t(images[0]), t(distribs[0]), t(states[0]),
                       t(ctx_actions[0]))
    for got, ref_leaf in zip(jax.tree.leaves(carry[0]),
                             jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_leaf),
                                   atol=TOL)
    got = ref.rollout(carry, t(plans), None if latents is None
                      else t(latents))
    assert tuple(got.shape) == want.shape == (b, steps, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
