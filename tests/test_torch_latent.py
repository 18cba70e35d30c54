"""Port parity: ``visual_foresight_torch.models.latent`` (the posterior
encoder, the KL to the standard normal, the reparameterized sample) against
the JAX package's ``models/latent.py`` on carried weights.  Inputs and the
perturbation of the initial weights come from numpy with a fixed seed.

Tolerances: f32 1e-5 (the same arithmetic in another order; the inputs and
outputs are of order one); bf16 2e-2 of the largest output (the tower runs
in bf16 on both sides, rounding in other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_tpu.models import latent as jlatent
from visual_foresight_torch.models import latent as tlatent
from visual_foresight_torch.models.convert import (load_flax_params,
                                                   params_from_flax,
                                                   params_to_flax)

F32_TOL = 1e-5
BF16_REL_TOL = 2e-2
FEATURES = (8, 16, 16)
LATENT = 4


def _encoders(dtype, t, h, w, seed=0):
    """The JAX encoder with its initial weights perturbed by seeded noise
    (so biases and LayerNorm offsets are not zero), and the port's with the
    same weights."""
    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = jlatent.PosteriorEncoder(latent_dim=LATENT, features=FEATURES,
                                  dtype=jdt)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, t, h, w, 3)))
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32), params)
    tm = tlatent.PosteriorEncoder(LATENT, FEATURES, dtype=dtype)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('t,h,w', [(6, 48, 64), (5, 16, 24), (1, 13, 10)],
                         ids=['48x64', '16x24', 'one-frame-odd'])
def test_posterior_encoder_matches_jax(t, h, w, dtype):
    """Frame pairs (a one-frame sequence pairs the frame with itself), the
    stride-2 SAME tower on even and odd sizes, the pools and the f32 heads,
    ``log_var`` clipped."""
    jm, params, tm = _encoders(dtype, t, h, w, seed=t + h)
    images = np.random.RandomState(h).rand(3, t, h, w, 3).astype(np.float32)
    mu, log_var = jm.apply(params, jnp.asarray(images))
    with torch.no_grad():
        tmu, tlv = tm(torch.tensor(images))
    assert tmu.dtype == tlv.dtype == torch.float32
    for got, want in ((tmu, mu), (tlv, log_var)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        if dtype == torch.float32:
            assert err <= F32_TOL
        else:
            assert err <= BF16_REL_TOL * float(np.abs(want).max())


def test_log_var_is_clipped_like_jax():
    """A head bias far outside [-10, 10] clips on both sides the same."""
    jm, params, tm = _encoders(torch.float32, 3, 16, 16)
    params = jax.tree.map(lambda x: x, params)
    params['params']['log_var']['bias'] = np.asarray(
        [40.0, -40.0, 0.0, 9.0], np.float32)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    images = np.random.RandomState(1).rand(2, 3, 16, 16, 3).astype(
        np.float32)
    _, log_var = jm.apply(params, jnp.asarray(images))
    with torch.no_grad():
        _, tlv = tm(torch.tensor(images))
    np.testing.assert_allclose(tlv.numpy(), np.asarray(log_var), rtol=0,
                               atol=F32_TOL)
    assert float(tlv[:, 0].min()) == 10.0 and float(tlv[:, 1].max()) == -10.0


def test_kl_and_reparameterize_match_jax():
    """The KL with JAX's formula; the sample with JAX's normals given as
    ``eps``; a generator's sample has the posterior's shape."""
    rng = np.random.RandomState(2)
    mu = rng.randn(5, LATENT).astype(np.float32)
    log_var = rng.randn(5, LATENT).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_z = jlatent.reparameterize(key, jnp.asarray(mu),
                                    jnp.asarray(log_var))
    eps = np.asarray(jax.random.normal(key, mu.shape))
    got_z = tlatent.reparameterize(None, torch.tensor(mu),
                                   torch.tensor(log_var),
                                   eps=torch.tensor(eps))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=0,
                               atol=F32_TOL)
    want_kl = jlatent.kl_to_standard_normal(jnp.asarray(mu),
                                            jnp.asarray(log_var))
    got_kl = tlatent.kl_to_standard_normal(torch.tensor(mu),
                                           torch.tensor(log_var))
    assert abs(float(got_kl) - float(want_kl)) <= F32_TOL * abs(
        float(want_kl))
    drawn = tlatent.reparameterize(torch.Generator().manual_seed(0),
                                   torch.tensor(mu), torch.tensor(log_var))
    assert drawn.shape == mu.shape and torch.isfinite(drawn).all()


def test_posterior_tree_round_trips_through_params_to_flax():
    """``params_to_flax`` of the carried state gives back the JAX tree, leaf
    for leaf (the heads as Dense kernels, the tower as HWIO conv kernels,
    the LayerNorms as ``ln/scale`` and ``ln/bias``)."""
    _, params, tm = _encoders(torch.float32, 3, 16, 16)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = params_to_flax(tm.state_dict())
    for path, leaf in want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    assert set(params_from_flax(got)) == set(tm.state_dict())
