"""Port parity: ``visual_foresight_torch.planners`` against the JAX
planners, in every mode the Gaussian sampler reaches.  Random draws are
injected: the test makes JAX's normals (plan noise, rejection rounds, and the
latents of a stochastic model) from its own key splits and hands them to the
port.

Tolerances: planner math 1e-5 (f32, the same arithmetic); a whole replan
rtol 1e-4 on the scores (f32 through a small model and three CEM
iterations) with identical elite indices.  In the mode cases the elite plans
get rtol 5e-5 beside atol 1e-5: plans of later iterations come through the
Cholesky factor of a refit from 8 elites, which amplifies f32 rounding
(measured 9e-6 relative on the grasp dim, whose std is 2).  Chunked against
unchunked in the port: equal elites, plans and refit, scores rtol 1e-6."""

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
CHUNK_RTOL = 1e-6
MODE_ACTION_RTOL = 5e-5
HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
      'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
      'nactions': 5, 'repeat': 3}

TORCH_THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    """At most ``TORCH_THREADS`` torch threads a test.  The suite runs in
    several processes at once; with torch's whole thread pool in each, the
    cores are oversubscribed and a replay that takes 2 s alone took 250 s.
    Autouse here and in every port test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


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


def test_goal_image_classifier_and_ensemble_costs():
    rng = np.random.RandomState(6)
    close = lambda a, b: np.testing.assert_allclose(_np(a), _np(b),
                                                    atol=TOL, rtol=TOL)
    vids = rng.rand(4, 5, 2, 6, 8, 3).astype(np.float32)
    goal = rng.rand(2, 6, 8, 3).astype(np.float32)
    for final_frames in (1, 3):
        close(tcosts.goal_image_mse(torch.tensor(vids), torch.tensor(goal),
                                    final_frames),
              jcosts.goal_image_mse(jnp.asarray(vids), jnp.asarray(goal),
                                    final_frames))
    logits = (rng.randn(7) * 4).astype(np.float32)
    close(tcosts.classifier_logprob_cost(torch.tensor(logits)),
          jcosts.classifier_logprob_cost(jnp.asarray(logits)))
    # three members: dividing the variance by N - 1 would miss by a half
    scores = rng.rand(3, 9).astype(np.float32)
    close(tcosts.ensemble_cost(torch.tensor(scores), 2.0),
          jcosts.ensemble_cost(jnp.asarray(scores), 2.0))


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


def _jax_sample_normals(k_sample, m, dim, rejection_rounds=0):
    """The normals of one ``gaussian.sample_actions`` call: the first draw,
    then one per rejection round."""
    key, sub = jax.random.split(k_sample)
    zs = [np.asarray(jax.random.normal(sub, (m, dim)))]
    for _ in range(rejection_rounds):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(sub, (m, dim))))
    return np.stack(zs) if rejection_rounds else zs[0]


def _jax_replan_draws(key, iterations, m, dim, rejection_rounds=0,
                      stochastic_k=1, latent_dim=0, chunk=0, n_vis=0):
    """Every normal that JAX's replan draws at ``m`` samples (cem.py: one
    key split per iteration; ``k_sample`` feeds ``sample_actions``,
    ``k_model`` the latents: all samples at once, or one split of it per
    chunk, and ``k_model`` itself once more for the chunked vis re-roll).

    :return: (noise, latents, vis_latents); the last two ``None`` without a
        latent
    """
    noise, latents, vis = [], [], None
    for _ in range(iterations):
        key, k_sample, k_model, _ = jax.random.split(key, 4)
        noise.append(_jax_sample_normals(k_sample, m // stochastic_k, dim,
                                         rejection_rounds))
        if not latent_dim:
            continue
        if chunk:
            keys = jax.random.split(k_model, m // chunk)
            latents.append(np.concatenate([np.asarray(jax.random.normal(
                k, (chunk, latent_dim))) for k in keys]))
            vis = np.asarray(jax.random.normal(k_model, (n_vis, latent_dim)))
        else:
            latents.append(np.asarray(jax.random.normal(
                k_model, (m, latent_dim))))
    return np.stack(noise), np.stack(latents) if latents else None, vis


def _jax_replan_noise(key, iterations, m, dim):
    """The plan normals alone (no rejection, no latent)."""
    return _jax_replan_draws(key, iterations, m, dim)[0]


def test_whole_replan_matches_jax():
    _check_replan_against_jax(num_samples=None)


def test_warm_start_replan_with_fewer_samples_matches_jax():
    """A replan shrunk from the configured 16 samples to 12, as warm
    starts shrink it by ``reuse_factor``."""
    _check_replan_against_jax(num_samples=12)


def small_models(adim=3, sdim=3, latent_dim=0, ncam=1, h=16, w=32,
                 model_kw=None):
    """A small JAX model with perturbed weights per camera, the port's
    modules on the same weights, and a seeded context; ``model_kw``
    overrides the space-to-depth model's options.

    :return: (jax model, per-camera params, port modules, images, states,
        distribs, context actions, goal pixels)
    """
    kw = dict(dict(num_distribs=1, std_factor=4, enc_features=(8, 16, 16),
                   lstm_kernel=3, separable_lstm=True, renorm_distribs=False,
                   mask_softmax='fullres', latent_dim=latent_dim, sdim=sdim,
                   adim=adim), **(model_kw or {}))
    jmodel = JaxPredictor(**kw)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, h, w, 3)),
                         jnp.zeros((1, 4, adim)), jnp.zeros((1, 2, sdim)),
                         jnp.zeros((1, 2, h, w, 1)))
    rng = np.random.RandomState(4)
    leaves, tree = jax.tree.flatten(params)
    cam_params = [jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        for x in leaves]) for _ in range(ncam)]
    images = rng.rand(ncam, 2, h, w, 3).astype(np.float32)
    states = (rng.randn(2, sdim) * 0.05).astype(np.float32)
    distribs = np.zeros((ncam, 2, h, w, 1), np.float32)
    distribs[:, :, 8, 16, 0] = 1.0
    actions = np.zeros((1, adim), np.float32)
    goal = np.tile(np.array([[[4.0, 25.0]]], np.float32), (ncam, 1, 1))
    tmodels = []
    for p in cam_params:
        tmodels.append(CDNAPredictor((h, w), **kw))
        load_flax_params(tmodels[-1], jax.tree.map(np.asarray, p))
    return (jmodel, cam_params, tmodels, images, states, distribs, actions,
            goal)


def _check_replan_against_jax(num_samples=None, modes=None, latent_dim=0,
                              ncam=1, adim=3, sdim=3, cost_fn=None,
                              cost_ctx=None, iters=3, m=16, k_elite=8,
                              equals_unchunked=False, action_rtol=0.0,
                              model_kw=None):
    h, w = 16, 32
    modes = dict(modes or {})
    hp = dict(HP, nactions=2, repeat=2,
              action_order=['x', 'z', 'grasp'] if adim == 3 else None)
    jspec, tspec = jgauss.make_action_spec(hp, adim), \
        tgauss.make_action_spec(hp, adim)
    dim = tspec.nactions * tspec.adim
    (jmodel, cam_params, tmodels, images, states, distribs, actions,
     goal) = small_models(adim, sdim, latent_dim, ncam, h, w, model_kw)
    mean0 = np.zeros(dim, np.float32)
    sigma0 = np.asarray(jgauss.initial_sigma(jspec))
    key = jax.random.PRNGKey(7)
    jcost, tcost = cost_fn or (None, None)
    jctx = jcosts.distance_grid(goal, h, w) if cost_ctx is None \
        else jnp.asarray(cost_ctx)
    tctx = tcosts.distance_grid(goal, h, w) if cost_ctx is None \
        else torch.tensor(cost_ctx)

    jplanner = JaxPlanner(jmodel, jspec, m, iterations=iters,
                          k_elite=k_elite, n_vis=2, cost_fn=jcost, **modes)
    want = jplanner.replan(cam_params, key, images, states, distribs,
                           actions, jctx, mean0, sigma0,
                           num_samples=num_samples)
    n = num_samples or m
    assert want['scores_per_itr'].shape == (iters, n)

    chunk = modes.get('sample_chunk', 0)
    chunked = bool(chunk) and n > chunk and n % chunk == 0
    noise, latents, vis_latents = _jax_replan_draws(
        key, iters, n, dim, modes.get('rejection_rounds', 0),
        modes.get('stochastic_k', 1), latent_dim, chunk if chunked else 0, 2)

    def port_replan(**over):
        planner = FusedCEMPlanner(
            tspec, m, iterations=iters, k_elite=k_elite, n_vis=2,
            cost_fn=tcost, device='cpu', **dict(modes, **over))
        return planner.replan(tmodels, images, states, distribs, actions,
                              tctx, mean0, sigma0, noise=noise,
                              latents=latents, vis_latents=vis_latents,
                              num_samples=num_samples)

    got = port_replan()
    np.testing.assert_allclose(_np(got['scores_per_itr']),
                               np.asarray(want['scores_per_itr']),
                               rtol=REPLAN_RTOL)
    np.testing.assert_array_equal(got['vis']['indices'].numpy(),
                                  np.asarray(want['vis']['indices']))
    np.testing.assert_allclose(_np(got['best_actions']),
                               np.asarray(want['best_actions']), atol=TOL,
                               rtol=action_rtol)
    np.testing.assert_allclose(_np(got['best_scores']),
                               np.asarray(want['best_scores']),
                               rtol=REPLAN_RTOL)
    np.testing.assert_allclose(_np(got['mean']), np.asarray(want['mean']),
                               atol=TOL, rtol=action_rtol)
    np.testing.assert_allclose(_np(got['sigma']), np.asarray(want['sigma']),
                               atol=TOL)
    for key_ in ('gen_images', 'gen_distribs'):
        np.testing.assert_allclose(_np(got['vis'][key_]),
                                   np.asarray(want['vis'][key_]), atol=1e-4,
                                   err_msg=key_)
    if not modes.get('stochastic_penalty'):
        for itr in range(iters):
            np.testing.assert_array_equal(
                np.argsort(_np(got['scores_per_itr'][itr]),
                           kind='stable')[:k_elite],
                np.argsort(np.asarray(want['scores_per_itr'][itr]),
                           kind='stable')[:k_elite])
    if equals_unchunked:
        # a deterministic model: chunking changes the working set alone.
        # The elites, and with them the plans and the refit, are exactly
        # equal; the scores agree to CHUNK_RTOL (the CPU library's sums
        # depend on the batch size in the last bits)
        plain = port_replan(sample_chunk=0)
        for key_ in ('best_actions', 'mean', 'sigma'):
            assert torch.equal(got[key_], plain[key_]), key_
        assert torch.equal(got['vis']['indices'], plain['vis']['indices'])
        for a, b in ((got['scores_per_itr'], plain['scores_per_itr']),
                     (got['best_scores'], plain['best_scores']),
                     (got['vis']['gen_images'], plain['vis']['gen_images'])):
            np.testing.assert_allclose(_np(a), _np(b), rtol=CHUNK_RTOL,
                                       atol=CHUNK_RTOL)


def test_rejection_sampling_resamples_then_clamps():
    """``sample_actions`` with rejection rounds against JAX: rows outside
    1.5 std are resampled round by round and what is left is clamped; with
    a wide covariance most rows are still invalid after 2 rounds."""
    spec = tgauss.make_action_spec(dict(HP, action_order=None), 4)
    dim, n, rounds = spec.nactions * spec.adim, 9, 2
    sigma = 4.0 * np.asarray(jgauss.initial_sigma(spec))
    mean = np.zeros(dim, np.float32)
    key = jax.random.PRNGKey(12)
    want = jgauss.sample_actions(key, jnp.asarray(mean), jnp.asarray(sigma),
                                 spec, n, rejection_rounds=rounds)
    z = _jax_sample_normals(key, n, dim, rounds)
    got = tgauss.sample_actions(torch.tensor(mean), torch.tensor(sigma), spec,
                                n, rejection_rounds=rounds,
                                z=torch.tensor(z))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)
    assert float(got[..., 0].abs().max()) == pytest.approx(
        1.5 * spec.xy_std, abs=1e-6)      # something was clamped
    with pytest.raises(ValueError, match='expected'):
        tgauss.sample_actions(torch.tensor(mean), torch.tensor(sigma), spec,
                              n, rejection_rounds=rounds,
                              z=torch.tensor(z[0]))
    drawn = tgauss.sample_actions(
        torch.tensor(mean), torch.tensor(sigma), spec, n,
        rejection_rounds=rounds, generator=torch.Generator().manual_seed(0))
    assert float(drawn[..., 2].abs().max()) <= 1.5 * spec.lift_std + 1e-6


def test_replan_rejects_fewer_samples_than_elites():
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    planner = FusedCEMPlanner(spec, 8, k_elite=4, device='cpu')
    with pytest.raises(ValueError, match='exceeds'):
        planner.replan([], None, None, None, None, None, None, None,
                       noise=np.zeros((3, 3, 15)), num_samples=3)


def test_chunked_vis_with_fewer_elites_than_n_vis():
    """4 elites, ``n_vis`` 6: the chunked re-roll returns the 4 elites'
    videos as the unchunked gather does (the JAX planner's chunked re-roll
    fails to trace there, ROADMAP.md section 3)."""
    spec = tgauss.make_action_spec(dict(HP, nactions=2, repeat=2,
                                        action_order=['x', 'z', 'grasp']), 3)
    model = CDNAPredictor((16, 32), num_distribs=1, num_masks=4,
                          enc_features=(8, 16, 16), lstm_kernel=3,
                          separable_lstm=True, std_factor=4)
    rng = np.random.RandomState(9)
    distribs = np.zeros((1, 2, 16, 32, 1), np.float32)
    distribs[:, :, 8, 16, 0] = 1.0
    outs = []
    for chunk in (0, 8):
        planner = FusedCEMPlanner(spec, 16, iterations=2, k_elite=4, n_vis=6,
                                  sample_chunk=chunk, device='cpu')
        outs.append(planner.replan(
            [model], rng.rand(1, 2, 16, 32, 3), np.zeros((2, 3)), distribs,
            np.zeros((1, 3)), tcosts.distance_grid([[[4.0, 25.0]]], 16, 32),
            np.zeros(6), _np(tgauss.initial_sigma(spec)),
            noise=np.random.RandomState(10).randn(2, 16, 6))['vis'])
        rng = np.random.RandomState(9)
    assert tuple(outs[1]['gen_images'].shape) == (4, 4, 1, 16, 32, 3)
    assert torch.equal(outs[0]['indices'], outs[1]['indices'])
    np.testing.assert_allclose(_np(outs[1]['gen_distribs']),
                               _np(outs[0]['gen_distribs']), atol=TOL)


def test_replan_argument_checks():
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    make = lambda **kw: FusedCEMPlanner(spec, 8, k_elite=2, device='cpu',
                                        **kw)
    for bad in (dict(stochastic_k=3), dict(stochastic_penalty=1.0),
                dict(sample_chunk=3), dict(sample_chunk=1)):
        with pytest.raises(ValueError):
            make(**bad)
    noise = np.zeros((3, 3, 15))
    run = lambda planner, n, models=(): planner.replan(
        list(models), None, None, None, None, None, None, None, noise=noise,
        num_samples=n)
    with pytest.raises(ValueError, match='multiple of stochastic_k'):
        run(make(stochastic_k=2), 7)
    # fewer unique plans than elites: the JAX planner has no such guard
    with pytest.raises(ValueError, match='unique plans'):
        run(make(stochastic_k=4, stochastic_penalty=1.0), 4)
    latent_model = CDNAPredictor((16, 32), latent_dim=2, num_distribs=1,
                                 std_factor=4)
    with pytest.raises(ValueError, match='latents beside noise'):
        run(make(), 6, [latent_model])


@pytest.mark.parametrize('mode', [{'mesh': 'any'}])
def test_unported_planner_modes_raise(mode):
    """Sample-axis sharding over a mesh is the one mode not ported (the
    others are held against JAX in ``tests/test_torch_planner_samplers.py``)."""
    spec = tgauss.make_action_spec(dict(HP, action_order=['x', 'z', 'grasp']),
                                   3)
    with pytest.raises(NotImplementedError):
        FusedCEMPlanner(spec, 8, k_elite=2, device='cpu', **mode)
    # the values that leave the modes off are accepted
    FusedCEMPlanner(spec, 8, k_elite=2, device='cpu', stochastic_k=1,
                    rejection_rounds=0, mppi=None, mesh=None)
