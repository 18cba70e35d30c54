"""Port parity: ``FusedCEMPlanner`` in the modes of the other samplers --
MPPI (``CorrelatedNoiseSampler``), the autograsp latch and resample
(``AutograspSampler``), ``AutograspEpsilon`` and the folding prior -- against
the JAX planner, with every draw of JAX's key chain (normals, uniforms,
waypoints, latents) made again here and injected.  Counterparts of
``tests/test_planner.py``'s MPPI cases and ``tests/test_samplers.py``'s
device cases, run as whole replans.

The folding prior factors its covariances with ``eigh``, whose
eigenvectors are fixed only up to sign and, where eigenvalues (nearly)
repeat, within their space: a refit covariance that differs in its last bits
can then give another factor, and other samples.  The port's factor is held
against JAX's in ``tests/test_torch_samplers.py``; here both planners factor
through one function that is continuous in the covariance (the Cholesky
factor of the eigenvalue-clipped matrix after a 1e-6 ridge), patched into
both modules.

Each replan runs two iterations: the second samples from the first one's
update.  Tolerances (f32, small model): scores rtol 1e-5 with identical
elites in every iteration; elite plans, refit mean and covariance (MPPI: the mean
plan) atol 1e-5 beside rtol 5e-5 (later plans come through a factor of a
refit, ``tests/test_torch_planner.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import (HP, MODE_ACTION_RTOL, _jax_sample_normals,
                                _np, small_models)
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_samplers import jax_folding_draws
from visual_foresight_torch.planners import costs as tcosts
from visual_foresight_torch.planners import gaussian as tgauss
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_tpu.planners import costs as jcosts
from visual_foresight_tpu.planners import gaussian as jgauss
from visual_foresight_tpu.planners.cem import FusedCEMPlanner as JaxPlanner

SCORE_RTOL = 1e-5
TOL = 1e-5
H, W = 16, 32
MPPI = {'kappa': 1.0, 'beta_0': 0.5, 'beta_1': 0.5, 'refit_cov': False,
        'mean_bias': None, 'per_dim_std': (0.05, 0.2, 1.0)}
AG = {'z_thresh': 0.0, 'norm_factor': 1.0, 'close_cmd': 1.0,
      'open_cmd': -1.0, 'reopen': False, 'deviation_prob': 0.0,
      'no_refit': True}
AG_EPS = {'z_dim': 2, 'grip_dim': 3, 'z_norm': 1.0, 'zthresh': 0.0,
          'epsilon': 0.5, 'base_frac': 1.0, 'base_frac_reduce': 0.3,
          'repeat': 2, 'state_z_index': 2}


def _spec(gauss, kind, adim):
    """(spec, model adim) of a case."""
    if kind == 'mppi':
        stds = MPPI['per_dim_std']
        return gauss.ActionSpec(
            adim=3, nactions=4, repeat=1, per_dim_std=stds, clip_dims_xy=(),
            clip_dims_rot=(), rej_dims_xy=(), rej_dims_lift=(),
            xy_std=stds[0], lift_std=stds[1])
    if kind == 'autograsp':       # base dims x, y, z; the grip is derived
        return gauss.make_action_spec(dict(HP, nactions=2, repeat=2,
                                           action_order=None), adim - 1)
    if kind == 'ag_epsilon':
        return gauss.make_action_spec(dict(
            HP, nactions=2, repeat=2,
            action_order=['x', 'y', 'z', 'grasp']), adim)
    return gauss.make_action_spec(dict(HP, nactions=5, repeat=1,
                                       action_order=None), adim)


def jax_mode_draws(key, iterations, m, spec, modes, latent_dim=0):
    """Every draw of the JAX replan in ``modes``, as the port takes them:
    per iteration a dict with 'z' and the mode's 'way', 'eps', 'grip'."""
    n, adim = spec.nactions, spec.adim
    T = n * spec.repeat
    noise, latents = [], []
    for itr in range(iterations):
        key, k_sample, k_model, k_grip = jax.random.split(key, 4)
        if modes.get('mppi'):
            d = {'z': np.asarray(jax.random.normal(
                k_sample, (m, n, adim))).reshape(m, -1)}
        elif modes.get('folding'):
            d = jax_folding_draws(k_sample, m, n, adim,
                                  modes['folding']['split_frac'],
                                  first_itr=itr == 0)
        else:
            d = {'z': _jax_sample_normals(k_sample, m, n * adim,
                                          modes.get('rejection_rounds', 0))}
        ae, ag = modes.get('ag_epsilon'), modes.get('autograsp')
        if ae:
            amount = max(int(m * ae['base_frac'] *
                             ae['base_frac_reduce'] ** itr), 1)
            d['grip'] = np.asarray(jax.random.uniform(k_grip, (amount, T)))
        if ag and (itr == 0 or ag['no_refit']):
            if ag['deviation_prob']:
                d['grip'] = np.asarray(jax.random.uniform(
                    jax.random.split(k_grip)[1], (m, T)))
        elif ag:
            d['grip'] = np.asarray(jax.random.uniform(k_grip, (m, T)))
        noise.append(d)
        if latent_dim:
            latents.append(np.asarray(jax.random.normal(
                k_model, (m, latent_dim))))
    return noise, (np.stack(latents) if latents else None)


def _ridge_factor_jax(sigma, eps=1e-10):
    """The Cholesky factor of the eigenvalue-clipped matrix (which, unlike
    its eigenvectors, is continuous in ``sigma``) after a 1e-6 ridge."""
    w, v = jnp.linalg.eigh(0.5 * (sigma + sigma.T))
    psd = (v * jnp.clip(w, eps, None)) @ v.T
    return jnp.linalg.cholesky(psd + 1e-6 * jnp.eye(psd.shape[0]))


def _ridge_factor_torch(sigma, eps=1e-10):
    w, v = torch.linalg.eigh(0.5 * (sigma + sigma.T))
    psd = (v * torch.clamp(w, min=eps)) @ v.T
    return torch.linalg.cholesky(psd + 1e-6 * torch.eye(
        psd.shape[0], device=psd.device))


# name -> (kind, planner modes, model adim, samples, elites, options).  The
# Gaussian refits keep plan dims + 1 distinct elites (full rank, ROADMAP.md
# section 3): 6 base dims for autograsp, 8 for ag_epsilon, 20 for folding.
# Two iterations: the second samples from the first one's update.
MODE_CASES = {
    # the AR(1) chain wraps around on the last step's noise
    'mppi': ('mppi', dict(mppi=MPPI), 3, 16, 5, {}),
    # the first iteration colours by the stds plus a bias, the second by the
    # refit covariance; the chain starts from the anchor
    'mppi_refit_cov_bias_anchor_latent': ('mppi', dict(mppi=dict(
        MPPI, refit_cov=True, mean_bias=[0.01, 0.0, 0.0], kappa=5.0)), 3,
        16, 5, dict(anchor=[0.02, -0.1, 0.3], anchor_valid=1.0,
                    latent_dim=4)),
    # the sticky latch in both iterations
    'autograsp_latch': ('autograsp', dict(autograsp=AG), 4, 16, 8, {}),
    # the reopening latch with deviations, then the resample from the elites
    'autograsp_reopen_deviation_resample_latent': ('autograsp', dict(
        autograsp=dict(AG, reopen=True, no_refit=False,
                       deviation_prob=0.2)), 4, 16, 8, dict(latent_dim=4)),
    'ag_epsilon_rejection': ('ag_epsilon', dict(ag_epsilon=AG_EPS,
                                                rejection_rounds=2), 4, 24,
                             12, {}),
    'folding_latent': ('folding', dict(
        folding={'split_frac': 0.5, 'max_shift': (0.2, 0.2, 1.0 / 3)},
        action_bound=False), 4, 48, 24, dict(latent_dim=4)),
}


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_replan_sampler_modes_match_jax(case, monkeypatch):
    kind, modes, adim, m, k_elite, opts = MODE_CASES[case]
    latent_dim = opts.get('latent_dim', 0)
    anchor = opts.get('anchor')
    anchor_valid = opts.get('anchor_valid', 0.0)
    (jmodel, cam_params, tmodels, images, states, distribs, actions,
     goal) = small_models(adim=adim, sdim=3, latent_dim=latent_dim, h=H,
                          w=W)
    jspec, tspec = _spec(jgauss, kind, adim), _spec(tgauss, kind, adim)
    assert tuple(jspec) == tuple(tspec)
    mean0 = np.zeros(tspec.nactions * tspec.adim, np.float32)
    sigma0 = np.asarray(jgauss.initial_sigma(jspec))
    key = jax.random.PRNGKey(17)
    iters = 2

    noise, latents = jax_mode_draws(key, iters, m, tspec, modes, latent_dim)
    if kind == 'folding':
        monkeypatch.setattr(jgauss, '_psd_factor', _ridge_factor_jax)
        monkeypatch.setattr(tgauss, '_psd_factor', _ridge_factor_torch)
    want = JaxPlanner(jmodel, jspec, m, iterations=iters, k_elite=k_elite,
                      n_vis=2, **modes).replan(
        cam_params, key, images, states, distribs, actions,
        jcosts.distance_grid(goal, H, W), mean0, sigma0,
        anchor=None if anchor is None else jnp.asarray(anchor, jnp.float32),
        anchor_valid=anchor_valid)
    planner = FusedCEMPlanner(tspec, m, iterations=iters, k_elite=k_elite,
                              n_vis=2, device='cpu', **modes)
    assert planner.is_mppi == (kind == 'mppi')
    got = planner.replan(tmodels, images, states, distribs, actions,
                         tcosts.distance_grid(goal, H, W), mean0, sigma0,
                         noise=noise, latents=latents, anchor=anchor,
                         anchor_valid=anchor_valid)

    scores = _np(got['scores_per_itr'])
    np.testing.assert_allclose(scores, np.asarray(want['scores_per_itr']),
                               rtol=SCORE_RTOL)
    for itr in range(iters):
        np.testing.assert_array_equal(
            np.argsort(scores[itr], kind='stable')[:k_elite],
            np.argsort(np.asarray(want['scores_per_itr'][itr]),
                       kind='stable')[:k_elite], err_msg='itr {}'.format(itr))
    np.testing.assert_array_equal(got['vis']['indices'].numpy(),
                                  np.asarray(want['vis']['indices']))
    np.testing.assert_allclose(_np(got['best_scores']),
                               np.asarray(want['best_scores']),
                               rtol=SCORE_RTOL)
    for name in ('best_actions', 'mean', 'sigma'):
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                   atol=TOL, rtol=MODE_ACTION_RTOL,
                                   err_msg=name)
    best = _np(got['best_actions'])
    assert best.shape == (k_elite, tspec.nactions * tspec.repeat,
                          adim if kind != 'mppi' else 3)
    if kind == 'autograsp':
        assert set(np.unique(best[..., -1])) <= {-1.0, 1.0}
        assert tuple(got['mean'].shape) == (tspec.nactions * 3,)


def test_sampler_modes_draw_from_a_generator():
    """Each mode also draws for itself from a ``torch.Generator``."""
    _, _, tmodels, images, states, distribs, actions, goal = small_models(
        adim=4, sdim=3)
    for kind, modes, adim, m, k_elite, _ in (
            MODE_CASES['autograsp_latch'], MODE_CASES['ag_epsilon_rejection'],
            MODE_CASES['folding_latent']):
        spec = _spec(tgauss, kind, adim)
        out = FusedCEMPlanner(spec, m, iterations=2, k_elite=k_elite,
                              n_vis=2, device='cpu', **modes).replan(
            tmodels, images, states, distribs, actions,
            tcosts.distance_grid(goal, H, W),
            np.zeros(spec.nactions * spec.adim, np.float32),
            _np(tgauss.initial_sigma(spec)),
            generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out['scores_per_itr']).all(), kind


@pytest.mark.parametrize('modes', [
    dict(mppi=MPPI, autograsp=AG), dict(ag_epsilon=AG_EPS, mppi=MPPI),
    dict(ag_epsilon=AG_EPS, autograsp=AG),
    dict(folding={'split_frac': 0.5}, mppi=MPPI)])
def test_sampler_modes_that_do_not_compose_raise(modes):
    """The JAX planner's composition asserts, as ``ValueError``."""
    spec = _spec(tgauss, 'folding', 4)
    with pytest.raises(ValueError):
        FusedCEMPlanner(spec, 8, k_elite=2, device='cpu', **modes)
