"""Port parity: ``visual_foresight_torch.models.layers`` against the flax
layers, with the flax parameters carried over by ``params_from_flax``.
Tolerance 1e-5: f32 on both sides, the same arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.models import layers as jlayers
from visual_foresight_torch.models import layers as tlayers
from visual_foresight_torch.models.convert import (load_flax_params,
                                                   params_from_flax)

TOL = 1e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _perturbed(params, seed):
    """Random non-zero values everywhere (flax initializes biases to 0)."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.3)
        for x in leaves])


@pytest.mark.parametrize('form', ['dense', 'separable', 'external_x'])
def test_conv_lstm_cell_matches_flax(form):
    rng = np.random.RandomState(0)
    b, h, w, cin, feat, k = 2, 6, 8, 5, 4, 3
    xin = 4 * feat if form == 'external_x' else cin
    x = rng.randn(b, h, w, xin).astype(np.float32)
    c0 = rng.randn(b, h, w, feat).astype(np.float32)
    h0 = rng.randn(b, h, w, feat).astype(np.float32)
    jcell = jlayers.ConvLSTMCell(feat, (k, k), separable=form == 'separable',
                                 external_x=form == 'external_x')
    params = _perturbed(jcell.init(jax.random.PRNGKey(0), (c0, h0), x), 1)
    (jc, jh), _ = jcell.apply(params, (c0, h0), x)

    tcell = tlayers.ConvLSTMCell(cin, feat, (k, k),
                                 separable=form == 'separable',
                                 external_x=form == 'external_x')
    load_flax_params(tcell, _np_tree(params))
    with torch.no_grad():
        (tc, th), out = tcell((torch.tensor(c0), torch.tensor(h0)),
                              torch.tensor(x))
    assert out is th
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)


def test_layer_norm_matches_flax():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 4, 5, 16) * 2 + 1).astype(np.float32)
    jln = jlayers.LayerNorm()
    params = _perturbed(jln.init(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(jln.apply(params, x))
    tln = tlayers.LayerNorm(16)
    load_flax_params(tln, _np_tree(params))
    with torch.no_grad():
        got = tln(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_layer_norm_bf16_keeps_dtype():
    tln = tlayers.LayerNorm(8)
    x = torch.randn(2, 3, 8).to(torch.bfloat16)
    with torch.no_grad():
        y = tln(x)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (8,), eps=1e-6)
    assert float((y.float() - ref).abs().max()) < 2e-2


@pytest.mark.parametrize('size,stride,k', [(12, 2, 3), (4, 2, 3), (7, 2, 3),
                                           (8, 1, 3), (9, 3, 5)])
def test_same_pad_matches_numpy_oracle(size, stride, k):
    from numpy_cdna_ref import same_pad_amounts
    assert tlayers.same_pad(size, stride, k) == same_pad_amounts(size,
                                                                 stride, k)


def test_params_from_flax_layouts_and_errors():
    rng = np.random.RandomState(3)
    tree = {'params': {
        'conv': {'kernel': rng.randn(3, 3, 2, 5), 'bias': rng.randn(5)},
        'dw': {'kernel': rng.randn(3, 3, 1, 4)},
        'pw': {'kernel': rng.randn(1, 1, 4, 6)},
        'dense': {'kernel': rng.randn(7, 2)},
        'norm': {'ln': {'scale': rng.randn(4), 'bias': rng.randn(4)}},
    }}
    sd = params_from_flax(tree)
    t = tree['params']
    np.testing.assert_array_equal(sd['conv.weight'].numpy(),
                                  t['conv']['kernel'].transpose(3, 2, 0, 1)
                                  .astype(np.float32))
    assert tuple(sd['dw.weight'].shape) == (4, 1, 3, 3)
    np.testing.assert_array_equal(sd['pw.weight'].numpy(),
                                  t['pw']['kernel'][0, 0].T
                                  .astype(np.float32))
    np.testing.assert_array_equal(sd['dense.weight'].numpy(),
                                  t['dense']['kernel'].T.astype(np.float32))
    assert set(sd) >= {'norm.weight', 'norm.bias', 'conv.bias'}
    with pytest.raises(ValueError, match='cannot place'):
        params_from_flax({'x': {'embedding': np.zeros((2, 2))}})
    # a leaf without a port parameter, and a parameter without a leaf
    tln = tlayers.LayerNorm(4)
    with pytest.raises(ValueError, match='unconsumed'):
        load_flax_params(tln, {'ln': {'scale': np.ones(4), 'bias': np.ones(4)},
                               'extra': {'bias': np.ones(4)}})
    with pytest.raises(ValueError, match='unfilled'):
        load_flax_params(tln, {'ln': {'scale': np.ones(4)}})
