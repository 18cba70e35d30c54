"""Port parity: ``visual_foresight_torch.planners`` against the JAX
planners.  Random draws are injected: the test makes JAX's normals from its
own key splits and hands them to the port.

Tolerances: planner math 1e-5 (f32, the same arithmetic); a whole replan
rtol 1e-4 on the scores (f32 through a small model and three CEM
iterations) with identical elite indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_foresight_tpu.models.cdna import CDNAPredictor as JaxPredictor
from visual_foresight_tpu.planners import costs as jcosts
from visual_foresight_tpu.planners import gaussian as jgauss
from visual_foresight_tpu.planners.cem import FusedCEMPlanner as JaxPlanner
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import load_flax_params
from visual_foresight_torch.planners import costs as tcosts
from visual_foresight_torch.planners import gaussian as tgauss
from visual_foresight_torch.planners.cem import FusedCEMPlanner

TOL = 1e-5
REPLAN_RTOL = 1e-4
HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
      'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
      'nactions': 5, 'repeat': 3}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def test_distance_grid_and_expected_pixel_distance():
    rng = np.random.RandomState(0)
    goals = np.array([[[10.0, 50.0]], [[3.5, 7.0]]], np.float32)
    _close = lambda a, b: np.testing.assert_allclose(_np(a), _np(b),
                                                     atol=TOL, rtol=TOL)
    jg = jcosts.distance_grid(goals, 12, 16)
    tg = tcosts.distance_grid(goals, 12, 16)
    _close(tg, jg)
    d = rng.rand(4, 5, 2, 12, 16, 1).astype(np.float32)
    for ofv in (False, True):
        want = jcosts.expected_pixel_distance(jnp.asarray(d), jg, 10.0,
                                              only_first_view=ofv)
        got = tcosts.expected_pixel_distance(torch.tensor(d), tg, 10.0,
                                             only_first_view=ofv)
        _close(got, want)


@pytest.mark.parametrize('order,adim', [(['x', 'z', 'grasp'], 3),
                                        (None, 4), (['x', 'y', 'theta'], 3)])
def test_action_spec_sigma_truncate_and_refit(order, adim):
    hp = dict(HP, action_order=order)
    jspec, tspec = jgauss.make_action_spec(hp, adim), \
        tgauss.make_action_spec(hp, adim)
    assert tuple(jspec) == tuple(tspec)
    np.testing.assert_allclose(
        _np(tgauss.initial_sigma(tspec, 0.5, reduce=True)),
        np.asarray(jgauss.initial_sigma(jspec, 0.5, reduce=True)), atol=TOL)
    rng = np.random.RandomState(1)
    acts = (rng.randn(6, 15, tspec.adim) * 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(tgauss.truncate(torch.tensor(acts), tspec)),
        np.asarray(jgauss.truncate(jnp.asarray(acts), jspec)), atol=TOL)
    for blockdiag in (False, True):
        jm, js = jgauss.fit_elites(jnp.asarray(acts), jspec, blockdiag)
        tm, ts = tgauss.fit_elites(torch.tensor(acts), tspec, blockdiag)
        np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=TOL)
        np.testing.assert_allclose(_np(ts), np.asarray(js), atol=TOL)


@pytest.mark.parametrize('sigma_kind', ['diag', 'full', 'not_pd'])
def test_sample_actions_with_injected_normals(sigma_kind):
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    dim, n = spec.nactions * spec.adim, 7
    rng = np.random.RandomState(2)
    mean = (rng.randn(dim) * 0.05).astype(np.float32)
    if sigma_kind == 'diag':
        sigma = np.asarray(jgauss.initial_sigma(spec))
    elif sigma_kind == 'full':
        a = rng.randn(dim, dim).astype(np.float32) * 0.1
        sigma = (a @ a.T + 0.01 * np.eye(dim)).astype(np.float32)
    else:   # Cholesky fails: both sides fall back to the diagonal
        sigma = -np.eye(dim, dtype=np.float32)
    key = jax.random.PRNGKey(3)
    want = jgauss.sample_actions(key, jnp.asarray(mean), jnp.asarray(sigma),
                                 spec, n)
    z = jax.random.normal(jax.random.split(key)[1], (n, dim))
    got = tgauss.sample_actions(torch.tensor(mean), torch.tensor(sigma), spec,
                                n, z=torch.tensor(np.asarray(z)))
    assert tuple(got.shape) == (n, spec.nactions * spec.repeat, spec.adim)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


@pytest.mark.parametrize('order,adim,reuse', [(['x', 'z', 'grasp'], 3, 1.0),
                                              (None, 4, 0.5)])
def test_shift_sigma_matches_jax(order, adim, reuse):
    hp = dict(HP, action_order=order)
    jspec, tspec = jgauss.make_action_spec(hp, adim), \
        tgauss.make_action_spec(hp, adim)
    dim = tspec.nactions * tspec.adim
    a = np.random.RandomState(5).randn(dim, dim).astype(np.float32) * 0.1
    sigma = (a @ a.T).astype(np.float32)
    want = jgauss.shift_sigma(jnp.asarray(sigma), jspec, reuse)
    got = tgauss.shift_sigma(torch.tensor(sigma), tspec, reuse)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


def _jax_replan_noise(key, iterations, m, dim):
    """The standard normals JAX's replan draws (cem.py key split per
    iteration, then gaussian.sample_actions' split)."""
    zs = []
    for _ in range(iterations):
        key, k_sample, _, _ = jax.random.split(key, 4)
        _, sub = jax.random.split(k_sample)
        zs.append(np.asarray(jax.random.normal(sub, (m, dim))))
    return np.stack(zs)


def test_whole_replan_matches_jax():
    _check_replan_against_jax(num_samples=None)


def test_warm_start_replan_with_fewer_samples_matches_jax():
    """A replan shrunk from the configured 16 samples to 12, as warm
    starts shrink it by ``reuse_factor``."""
    _check_replan_against_jax(num_samples=12)


def _check_replan_against_jax(num_samples):
    h, w, m, iters, k_elite = 16, 32, 16, 3, 8
    kw = dict(num_distribs=1, std_factor=4, enc_features=(8, 16, 16),
              lstm_kernel=3, separable_lstm=True, renorm_distribs=False,
              mask_softmax='fullres')
    hp = dict(HP, nactions=2, repeat=2, action_order=['x', 'z', 'grasp'])
    jspec, tspec = jgauss.make_action_spec(hp, 3), \
        tgauss.make_action_spec(hp, 3)
    jmodel = JaxPredictor(**kw)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, h, w, 3)),
                         jnp.zeros((1, 4, 3)), jnp.zeros((1, 2, 3)),
                         jnp.zeros((1, 2, h, w, 1)))
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(4)
    params = jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        for x in leaves])
    images = rng.rand(1, 2, h, w, 3).astype(np.float32)
    states = (rng.randn(2, 3) * 0.05).astype(np.float32)
    distribs = np.zeros((1, 2, h, w, 1), np.float32)
    distribs[:, :, 8, 16, 0] = 1.0
    actions = np.zeros((1, 3), np.float32)
    goal = np.array([[[4.0, 25.0]]], np.float32)
    mean0 = np.zeros(6, np.float32)
    sigma0 = np.asarray(jgauss.initial_sigma(jspec))
    key = jax.random.PRNGKey(7)

    jplanner = JaxPlanner(jmodel, jspec, m, iterations=iters,
                          k_elite=k_elite, n_vis=2)
    want = jplanner.replan([params], key, images, states, distribs, actions,
                           jcosts.distance_grid(goal, h, w), mean0, sigma0,
                           num_samples=num_samples)
    assert want['scores_per_itr'].shape == (iters, num_samples or m)

    tmodel = CDNAPredictor((h, w), **kw)
    load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    planner = FusedCEMPlanner(tspec, m, iterations=iters, k_elite=k_elite,
                              n_vis=2, device='cpu')
    noise = _jax_replan_noise(key, iters, num_samples or m, 6)
    got = planner.replan([tmodel], images, states, distribs, actions,
                         tcosts.distance_grid(goal, h, w), mean0, sigma0,
                         noise=noise, num_samples=num_samples)
    np.testing.assert_allclose(_np(got['scores_per_itr']),
                               np.asarray(want['scores_per_itr']),
                               rtol=REPLAN_RTOL)
    for itr in range(iters):
        np.testing.assert_array_equal(
            np.argsort(_np(got['scores_per_itr'][itr]))[:k_elite],
            np.argsort(np.asarray(want['scores_per_itr'][itr]))[:k_elite])
    np.testing.assert_array_equal(got['vis']['indices'].numpy(),
                                  np.asarray(want['vis']['indices']))
    np.testing.assert_allclose(_np(got['best_actions']),
                               np.asarray(want['best_actions']), atol=TOL)
    np.testing.assert_allclose(_np(got['best_scores']),
                               np.asarray(want['best_scores']),
                               rtol=REPLAN_RTOL)
    np.testing.assert_allclose(_np(got['mean']), np.asarray(want['mean']),
                               atol=TOL)
    np.testing.assert_allclose(_np(got['vis']['gen_images']),
                               np.asarray(want['vis']['gen_images']),
                               atol=1e-4)


def test_replan_rejects_fewer_samples_than_elites():
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    planner = FusedCEMPlanner(spec, 8, k_elite=4, device='cpu')
    with pytest.raises(ValueError, match='exceeds'):
        planner.replan([], None, None, None, None, None, None, None,
                       noise=np.zeros((3, 3, 15)), num_samples=3)


@pytest.mark.parametrize('mode', [
    {'mppi': {'kappa': 1.0}}, {'stochastic_k': 2}, {'sample_chunk': 4},
    {'rejection_rounds': 2}, {'autograsp': {'z_thresh': 0.1}},
    {'folding': {'split_frac': 0.5}}, {'ag_epsilon': {'z_dim': 2}},
    {'discrete_dims': (1,)}, {'smooth_cov': True}])
def test_unported_planner_modes_raise(mode):
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    with pytest.raises(NotImplementedError):
        FusedCEMPlanner(spec, 8, k_elite=2, device='cpu', **mode)
    # the values that leave the modes off are accepted
    FusedCEMPlanner(spec, 8, k_elite=2, device='cpu', stochastic_k=1,
                    rejection_rounds=0, mppi=None)
