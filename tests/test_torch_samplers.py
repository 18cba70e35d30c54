"""Port parity: the samplers' device math in ``planners/gaussian.py`` and the
samplers' host draws, each against its JAX package twin.

Device helpers: the JAX function's random draws (uniforms, normals,
waypoints) are made again from its key and handed to the port.  The latch,
the resample and the AutograspEpsilon gripper give exactly the same
commands; the folding prior agrees to 1e-5 (f32 matrix products) once both
sides use the same eigen-factor: ``eigh`` fixes each eigenvector only up to
its sign (and within a repeated eigenvalue's space), so the factors
themselves are held against each other through ``F @ F.T`` (1e-5) and, for
distinct eigenvalues, column by column after the signs are normalised.

Host samplers: the JAX package's draw from the global ``np.random`` after
``np.random.seed(s)``, the port's from ``np.random.RandomState(s)``: the
same MT19937 stream, so every draw, refit and warm start must agree bit for
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.planners import gaussian as tgauss
from visual_foresight_torch.policy.cem_controllers.samplers import (
    autograsp_epsilon as t_age, autograsp_sampler as t_ag,
    correlated_noise as t_cn, folding_sampler as t_fold,
    gaussian_sampler as t_gauss)
from visual_foresight_torch.utils.hparams import HParams as THParams
from visual_foresight_tpu.planners import gaussian as jgauss
from visual_foresight_tpu.policy.cem_controllers.samplers import (
    autograsp_epsilon as j_age, autograsp_sampler as j_ag,
    correlated_noise as j_cn, folding_sampler as j_fold,
    gaussian_sampler as j_gauss)
from visual_foresight_tpu.utils.hparams import HParams as JHParams

TOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


# -- device helpers --------------------------------------------------------

@pytest.mark.parametrize('reopen,deviation_prob', [(False, 0.0), (True, 0.0),
                                                   (False, 0.3), (True, 0.3)])
def test_autograsp_latch_matches_jax(reopen, deviation_prob):
    rng = np.random.RandomState(3)
    base = (rng.randn(16, 12, 3) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(norm_factor=0.7, reopen=reopen, close_cmd=1.0, open_cmd=-1.0,
              z_index=2, deviation_prob=deviation_prob)
    want = jgauss.autograsp_gripper_latch(jnp.asarray(base), 0.35, 0.15,
                                          deviation_key=key, **kw)
    u = np.asarray(jax.random.uniform(key, (16, 12)))
    got = tgauss.autograsp_gripper_latch(torch.tensor(base), 0.35, 0.15,
                                         u=torch.tensor(u), **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    if deviation_prob:
        with pytest.raises(ValueError, match='deviation'):
            tgauss.autograsp_gripper_latch(torch.tensor(base), 0.35, 0.15,
                                           **kw)


def test_autograsp_resample_matches_jax():
    elites = np.zeros((4, 6, 4), np.float32)
    elites[..., -1] = -1.0
    elites[:, 2:, -1] = 1.0
    elites[0, 0, -1] = 1.0
    elites[1:3, 1, -1] = 1.0
    key = jax.random.PRNGKey(0)
    want = jgauss.autograsp_gripper_resample(key, jnp.asarray(elites), 40, 6)
    u = np.asarray(jax.random.uniform(key, (40, 6)))
    got = tgauss.autograsp_gripper_resample(torch.tensor(elites), 40, 6,
                                            u=torch.tensor(u))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize('epsilon,amount', [(0.0, 10), (0.5, 7), (1.0, 3)])
def test_ag_epsilon_transform_matches_jax(epsilon, amount):
    rng = np.random.RandomState(2)
    plans = (rng.randn(10, 12, 4) * 0.4).astype(np.float32)
    plans[0, :, 2] = 5.0        # never reaches the threshold: closes at t=0
    key = jax.random.PRNGKey(5)
    kw = dict(z_dim=2, grip_dim=3, z_norm=0.8, zthresh=0.1, epsilon=epsilon,
              repeat=3)
    want = np.asarray(jgauss.ag_epsilon_transform(
        key, jnp.asarray(plans), 0.25, amount, **kw))
    u = np.asarray(jax.random.uniform(key, (amount, 12)))
    got = _np(tgauss.ag_epsilon_transform(torch.tensor(plans), 0.25, amount,
                                          u=torch.tensor(u), **kw))
    np.testing.assert_array_equal(got, want)
    if epsilon == 0.0:
        assert (got[0, :, 3] == 1.0).all()      # open throughout: closes at 0
    np.testing.assert_array_equal(got[amount:], plans[amount:])


def _normalised_columns(f):
    """Eigen-factor columns with the sign that makes each column's largest
    entry positive."""
    f = np.asarray(f, np.float64)
    big = np.argmax(np.abs(f), axis=0)
    return f * np.sign(f[big, np.arange(f.shape[1])])[None]


@pytest.mark.parametrize('kind', ['spd', 'singular', 'indefinite'])
def test_psd_factor_matches_jax(kind):
    rng = np.random.RandomState(6)
    a = rng.randn(8, 8).astype(np.float32)
    sigma = {'spd': a @ a.T + np.eye(8, dtype=np.float32),
             'singular': a[:, :3] @ a[:, :3].T,
             'indefinite': a + a.T}[kind].astype(np.float32)
    jf = np.asarray(jgauss._psd_factor(jnp.asarray(sigma)))
    tf = _np(tgauss._psd_factor(torch.tensor(sigma)))
    scale = float(np.abs(sigma).max())
    np.testing.assert_allclose(tf @ tf.T, jf @ jf.T, atol=TOL * scale)
    if kind == 'spd':       # distinct eigenvalues: equal up to column sign
        np.testing.assert_allclose(_normalised_columns(tf),
                                   _normalised_columns(jf),
                                   atol=TOL * np.sqrt(scale))


def _folding_spec(jmod, n=6, repeat=2):
    return jmod.ActionSpec(adim=4, nactions=n, repeat=repeat,
                           per_dim_std=(0.05, 0.05, 0.15, 0.17),
                           clip_dims_xy=(), clip_dims_rot=(), rej_dims_xy=(),
                           rej_dims_lift=(), xy_std=0.05, lift_std=0.15)


def jax_folding_draws(key, nsamples, n, adim=4, split_frac=0.5,
                      first_itr=False):
    """The draws of one JAX ``folding_sample`` call, as the port takes
    them."""
    per_split = int((nsamples * split_frac) / 2)
    if first_itr:
        per_split = max(int(per_split / 2), 1)
    p2 = 2 * per_split
    k_w, k_eps, k_def = jax.random.split(key, 3)
    draws = {'way': np.asarray(jax.random.uniform(k_w, (p2, 2, 2))),
             'eps': np.asarray(jax.random.normal(k_eps, (p2, n, 4)))}
    if nsamples > p2:
        draws['z'] = np.asarray(jax.random.normal(
            k_def, (nsamples - p2, n * adim)))
    return draws


def jax_psd_factor(sigma, eps=1e-10):
    """The JAX package's eigen-factor of a torch matrix, as a torch tensor:
    patched in for the port's so that both sample alike."""
    f = jgauss._psd_factor(jnp.asarray(sigma.detach().cpu().numpy()), eps)
    return torch.tensor(np.asarray(f), device=sigma.device)


@pytest.mark.parametrize('nsamples,first_itr,max_shift', [
    (40, False, (5.0, 5.0, 5.0)), (40, True, (0.1, 0.1, 0.2)),
    (7, True, (0.2, 0.2, 1.0 / 3)), (4, False, (0.2, 0.2, 1.0 / 3))])
def test_folding_sample_matches_jax(nsamples, first_itr, max_shift,
                                    monkeypatch):
    n = 6
    rng = np.random.RandomState(7)
    a = rng.randn(n * 4, n * 4).astype(np.float32) * 0.05
    sigma = (a @ a.T + 1e-3 * np.eye(n * 4)).astype(np.float32)
    mean = (rng.randn(n * 4) * 0.1).astype(np.float32)
    state_xy = np.array([0.4, 0.6], np.float32)
    key = jax.random.PRNGKey(8)
    kw = dict(split_frac=0.5, max_shift=max_shift, first_itr=first_itr)
    want = np.asarray(jgauss.folding_sample(
        key, jnp.asarray(mean), jnp.asarray(sigma), jnp.asarray(state_xy),
        nsamples, _folding_spec(jgauss), **kw))
    monkeypatch.setattr(tgauss, '_psd_factor', jax_psd_factor)
    got = _np(tgauss.folding_sample(
        torch.tensor(mean), torch.tensor(sigma), torch.tensor(state_xy),
        nsamples, _folding_spec(tgauss),
        draws=jax_folding_draws(key, nsamples, n, first_itr=first_itr),
        **kw))
    assert got.shape == (nsamples, 2 * n, 4)
    np.testing.assert_allclose(got, want, atol=TOL)
    with pytest.raises(ValueError, match='generator'):
        tgauss.folding_sample(torch.tensor(mean), torch.tensor(sigma),
                              torch.tensor(state_xy), nsamples,
                              _folding_spec(tgauss), **kw)


def test_folding_sample_draws_from_a_generator():
    """The port's own factor and draws: the group structure of JAX's test
    (``tests/test_samplers.py::test_folding_sample_device_structure``)."""
    n, M = 6, 400
    plans = _np(tgauss.folding_sample(
        torch.full((n * 4,), 0.33), torch.eye(n * 4) * 4e-4,
        torch.tensor([0.4, 0.6]), M, _folding_spec(tgauss),
        max_shift=(5.0, 5.0, 5.0),
        generator=torch.Generator().manual_seed(0)))
    ctrl, ps = plans[:, ::2], 100
    np.testing.assert_allclose(ctrl[:ps, :5, 2].mean(axis=0),
                               [1, -1, 1, 1, -1], atol=0.05)
    np.testing.assert_array_equal(ctrl[ps:2 * ps, 3], ctrl[ps:2 * ps, 5])
    np.testing.assert_allclose(ctrl[2 * ps:].mean(), 0.33, atol=0.01)


# -- host samplers ---------------------------------------------------------

def _hp_pair(defaults, **over):
    d = dict(defaults, **over)
    return JHParams(**d), THParams(**d)


def _drive(jcls, tcls, hp_over, adim, sdim=4, seed=0, n=24, k=8,
           state=(0.1, -0.2, 0.3, 0.0), steps=(0, 3)):
    """Both samplers through an initial draw, a refit on its first ``k``
    plans, a logged best plan and the next replan's initial draw (a warm
    start where the hparams reuse): every array must be identical."""
    jhp, thp = _hp_pair(jcls.get_default_hparams(), **hp_over)
    js, ts = jcls(jhp, adim, sdim), tcls(thp, adim, sdim,
                                         rng=np.random.RandomState(seed))
    np.random.seed(seed)
    state = np.asarray(state, np.float64)
    for t in steps:
        want = js.sample_initial_actions(t, n, state)
        got = ts.sample_initial_actions(t, n, state)
        np.testing.assert_array_equal(got, want, err_msg='initial t={}'
                                      .format(t))
        scores = np.linspace(0.0, 1.0, want.shape[0])[::-1].copy()
        elites = want[-k:][::-1].copy()
        want = js.sample_next_actions(n, elites, scores[-k:][::-1].copy())
        got = ts.sample_next_actions(n, elites.copy(),
                                     scores[-k:][::-1].copy())
        np.testing.assert_array_equal(got, want, err_msg='next t={}'
                                      .format(t))
        for s in (js, ts):
            s.log_best_action(want[0, 0].copy(), want[:k, 1:].copy())
    return got


GAUSSIAN_CASES = {
    'defaults_rejection': {},
    'no_rejection': {'rejection_sampling': False},
    'warm_starts': {'reuse_mean': True, 'reuse_cov': True,
                    'reduce_std_dev': 0.5, 'rejection_sampling': False},
    'smooth_blockdiag_zero': {'smooth_cov': True, 'cov_blockdiag': True,
                              'add_zero_action': True,
                              'rejection_sampling': False},
    'stochastic_discrete': {'stochastic_planning': (2,),
                            'discrete_ind': [3]},
    'action_order': {'action_order': ['x', 'z', 'grasp', 'theta'],
                     'rejection_sampling': False},
}


@pytest.mark.parametrize('case', sorted(GAUSSIAN_CASES))
def test_gaussian_host_sampler_matches_jax(case):
    got = _drive(j_gauss.GaussianCEMSampler, t_gauss.GaussianCEMSampler,
                 dict(GAUSSIAN_CASES[case], nactions=3), adim=4)
    assert got.shape[1:] == (9, 4)


CORRELATED_CASES = {
    'defaults': {},
    'refit_cov_bias': {'refit_cov': True, 'mean_bias': [0.01, 0.0, 0.0, 0.0]},
    'anchored': {'smooth_across_last_action': True, 'beta_0': 0.7},
}


@pytest.mark.parametrize('case', sorted(CORRELATED_CASES))
def test_correlated_noise_sampler_matches_jax(case):
    got = _drive(j_cn.CorrelatedNoiseSampler, t_cn.CorrelatedNoiseSampler,
                 dict(CORRELATED_CASES[case], nactions=5), adim=4)
    assert got.shape[1:] == (5, 4)


AUTOGRASP_CASES = {
    'latch': {},
    'reopen_deviation': {'reopen': True, 'deviation_prob': 0.2},
    'resample': {'no_refit': False},
}


@pytest.mark.parametrize('case', sorted(AUTOGRASP_CASES))
def test_autograsp_sampler_matches_jax(case):
    got = _drive(j_ag.AutograspSampler, t_ag.AutograspSampler,
                 dict(AUTOGRASP_CASES[case], nactions=4, repeat=2,
                      z_thresh=0.35, rejection_sampling=False), adim=4)
    assert set(np.unique(got[..., -1])) <= {-1.0, 1.0}


@pytest.mark.parametrize('epsilon', [0.0, 0.5])
def test_autograsp_epsilon_sampler_matches_jax(epsilon):
    got = _drive(j_age.AutograspEpsilon, t_age.AutograspEpsilon,
                 dict(nactions=4, repeat=2, ag_epsilon=epsilon,
                      action_order=['x', 'y', 'z', 'grasp']), adim=4)
    assert got.shape[1:] == (8, 4)


@pytest.mark.parametrize('n', [24, 7])
def test_folding_sampler_matches_jax(n):
    got = _drive(j_fold.FoldingCEMSampler, t_fold.FoldingCEMSampler,
                 {'nactions': 6}, adim=4, n=n, k=min(n, 8),
                 state=(0.5, 0.5, 0.2, 0.0))
    assert got.shape == (n, 18, 4)


def test_samplers_draw_from_their_rng_only():
    """Two RandomStates with one seed give the same plans; the global
    ``np.random`` is left untouched."""
    hp = THParams(**dict(t_cn.CorrelatedNoiseSampler.get_default_hparams()))
    np.random.seed(1)
    before = np.random.get_state()[1].copy()
    a, b = (t_cn.CorrelatedNoiseSampler(hp, 4, 4,
                                        rng=np.random.RandomState(9))
            .sample_initial_actions(0, 8, None) for _ in range(2))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
