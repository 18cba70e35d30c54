"""Port parity: the planning costs' networks, ``visual_foresight_torch``'s
against the JAX package's on the same inputs and the same (converted)
parameters: ``bilinear_sample`` (coordinates inside, between pixels,
outside and negative), ``GoalDistanceNet``, ``SuccessClassifier`` with and
without a goal, ``NCEEmbedding`` and ``InverseNet``; the activation is
flax's tanh GELU (a case fails on the exact erf form); ``params_to_flax``
gives each network's flax tree back; ``restore_network`` reads a
``params.npz`` and falls back to seeded weights with a warning.

Parameters are JAX's ``init`` with seeded noise on every leaf (so that no
bias is zero).  Tolerance: f32, atol 1e-5 (flows, scaled by 10, and warp
points atol 1e-4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models import classifier as tclf
from visual_foresight_torch.models import gdn as tgdn
from visual_foresight_torch.models import inverse as tinv
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_to_flax,
                                                   perturbed_flat,
                                                   restore_network,
                                                   unflatten_flax)
from visual_foresight_tpu.models import classifier as jclf
from visual_foresight_tpu.models import gdn as jgdn
from visual_foresight_tpu.models import inverse as jinv

ATOL = 1e-5
FLOW_ATOL = 1e-4
H, W = 16, 24


def seeded(params, seed, scale=0.3, floor=0.1):
    """JAX parameters with seeded noise (``perturbed_flat``) on every leaf,
    as a flax tree of numpy arrays."""
    flat = {'/'.join(str(k.key) for k in path): np.asarray(leaf) for path,
            leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    return unflatten_flax(perturbed_flat(flat, seed, scale, floor))


def ported(module, tree):
    return load_flax_params(module, tree).eval()


def _np(x):
    return x.detach().numpy()


def _frames(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize('case', ['inside', 'outside_and_negative',
                                  'integer_points'])
def test_bilinear_sample_matches_jax(case):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 8, 10, 3).astype(np.float32)
    rr, cc = np.meshgrid(np.arange(8.0), np.arange(10.0), indexing='ij')
    if case == 'inside':
        coords = np.stack([rr, cc], -1)[None] + rng.uniform(
            0, 0.99, (2, 8, 10, 2))
        coords = np.minimum(coords, [7, 9])
    elif case == 'outside_and_negative':
        coords = rng.uniform(-4, 14, (2, 8, 10, 2))
        coords[0, 0, :4] = [-0.5, -1e-3]
        coords[0, 1, :4] = [7.5, 9.2]
    else:
        coords = np.stack([rr + 2, cc - 3], -1)[None].repeat(2, 0)
    coords = coords.astype(np.float32)
    want = np.asarray(jgdn.bilinear_sample(jnp.asarray(img),
                                           jnp.asarray(coords)))
    got = _np(tgdn.bilinear_sample(torch.tensor(img), torch.tensor(coords)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    if case == 'outside_and_negative':
        assert (want == 0).any() and (want != 0).any()


@pytest.mark.parametrize('features', [(8, 16, 32), tgdn.FEATURES],
                         ids=['narrow', 'default'])
def test_goal_distance_net_matches_jax(features):
    cur, ref = _frames(2, 2, H, W, 3), _frames(3, 2, H, W, 3)
    jnet = jgdn.GoalDistanceNet(features=features)
    tree = seeded(jnet.init(jax.random.PRNGKey(0), jnp.asarray(cur),
                            jnp.asarray(ref)), 4)
    want = jnet.apply(tree, jnp.asarray(cur), jnp.asarray(ref))
    got = ported(tgdn.GoalDistanceNet(features=features), tree)(
        torch.tensor(cur), torch.tensor(ref))
    for name, g, w, tol in zip(('warped', 'flow', 'warp_pts'), got, want,
                               (ATOL, FLOW_ATOL, FLOW_ATOL)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=tol,
                                   err_msg=name)
    assert float(np.abs(np.asarray(want[1])).max()) > 0.5   # a real flow


@pytest.mark.parametrize('goal_conditioned', [True, False])
def test_success_classifier_matches_jax(goal_conditioned):
    frame, goal = _frames(5, 6, H, W, 3), _frames(6, 6, H, W, 3)
    jnet = jclf.SuccessClassifier()
    args = (jnp.asarray(frame), jnp.asarray(goal)) if goal_conditioned \
        else (jnp.asarray(frame),)
    tree = seeded(jnet.init(jax.random.PRNGKey(0), *args), 7)
    want = np.asarray(jnet.apply(tree, *args))
    tnet = ported(tclf.SuccessClassifier(goal_conditioned=goal_conditioned),
                  tree)
    got = _np(tnet(*[torch.tensor(np.asarray(a)) for a in args]))
    assert got.shape == (6,)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError):
        tnet(torch.tensor(frame), *(() if goal_conditioned
                                    else (torch.tensor(goal),)))


def test_nce_embedding_matches_jax():
    frame, goal = _frames(8, 5, H, W, 3), _frames(9, 1, H, W, 3)
    jnet = jclf.NCEEmbedding()
    tree = seeded(jnet.init(jax.random.PRNGKey(0), jnp.asarray(frame)), 10)
    want = np.asarray(jnet.apply(tree, jnp.asarray(frame)))
    tnet = ported(tclf.NCEEmbedding(), tree)
    got = tnet(torch.tensor(frame))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(want, axis=-1), 1.0, atol=1e-6)
    g = tnet(torch.tensor(goal))
    np.testing.assert_allclose(
        _np(tclf.NCEEmbedding.score(got, g)),
        np.asarray(jclf.NCEEmbedding.score(jnp.asarray(want),
                                           jnet.apply(tree, goal))),
        atol=ATOL)


@pytest.mark.parametrize('adim,plan_T,num_context', [(3, 7, 2), (4, 5, 1)])
def test_inverse_net_matches_jax(adim, plan_T, num_context):
    cur, goal = _frames(11, 2, H, W, 3), _frames(12, 2, H, W, 3)
    ctx = _frames(13, 2, num_context, H, W, 3)
    jnet = jinv.InverseNet(adim, plan_T)
    tree = seeded(jnet.init(jax.random.PRNGKey(0), cur, goal, ctx), 14)
    want = np.asarray(jnet.apply(tree, cur, goal, ctx))
    got = _np(ported(tinv.InverseNet(adim, plan_T, num_context), tree)(
        torch.tensor(cur), torch.tensor(goal), torch.tensor(ctx)))
    assert got.shape == (2, plan_T, adim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gelu_is_the_tanh_form_and_the_erf_form_would_fail():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))       # flax's nn.gelu
    np.testing.assert_allclose(_np(tclf.gelu(torch.tensor(x))), want,
                               atol=1e-6)
    exact = _np(torch.nn.functional.gelu(torch.tensor(x)))
    assert np.abs(exact - want).max() > 10 * ATOL


@pytest.mark.parametrize('name', ['gdn', 'classifier', 'nce', 'inverse'])
def test_params_to_flax_gives_each_network_its_tree(name):
    frame = jnp.asarray(_frames(15, 1, H, W, 3))
    jnet, args, tnet = {
        'gdn': (jgdn.GoalDistanceNet(), (frame, frame),
                tgdn.GoalDistanceNet()),
        'classifier': (jclf.SuccessClassifier(), (frame, frame),
                       tclf.SuccessClassifier()),
        'nce': (jclf.NCEEmbedding(), (frame,), tclf.NCEEmbedding()),
        'inverse': (jinv.InverseNet(3, 7), (frame, frame, jnp.stack(
            [frame, frame], 1)), tinv.InverseNet(3, 7, 2)),
    }[name]
    tree = seeded(jnet.init(jax.random.PRNGKey(0), *args), 16)
    back = flatten_flax(params_to_flax(ported(tnet, tree).state_dict()))
    want = flatten_flax(tree)
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_restore_network_reads_params_npz_or_warns(tmp_path):
    net = tinv.InverseNet(3, 7, 2)
    flat = flatten_flax(params_to_flax(net.state_dict()))
    flat = perturbed_flat(flat, 17, 0.3, 0.1)
    np.savez(os.path.join(str(tmp_path), 'params.npz'), **flat)
    other = tinv.InverseNet(3, 7, 2)
    assert restore_network(other, str(tmp_path))
    got = flatten_flax(params_to_flax(other.state_dict()))
    for key, value in flat.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    with pytest.warns(UserWarning, match='seeded random weights'):
        assert not restore_network(other, str(tmp_path / 'missing'), seed=3)
    assert not restore_network(tinv.InverseNet(3, 7, 2), '')
    with pytest.raises(ValueError):       # a tree of another network
        restore_network(tinv.InverseNet(4, 7, 2), str(tmp_path))
