"""Port parity: the host CEM loop (``CEMBaseController.perform_CEM``) and the
warm-up draws, ``PixelCostController`` and ``GoalImController`` against the
JAX package's, side by side over a few ``act()`` steps at a small width.

The host loop runs where ``use_fused_planner`` is False or the sampler is
none of the five the device planner knows (matched by class identity, so a
subclass of the Gaussian sampler plans in the host loop too).  It samples on
the host: the JAX controller's samplers draw from the global ``np.random``
after ``np.random.seed(seed)``, the port's from the controller's
``np.random.RandomState(seed)``, so every plan is the same bit for bit as
long as the elites agree.  Each CEM iteration is one predictor call; both
run the teacher-forced forward over the context action and a plan that may
be shorter than ``T``.  A stochastic predictor draws its latent from
``PRNGKey(0)`` in JAX at every call: the port is handed that latent.

Tolerances: scores rtol 1e-5 (f32 through the small model) with equal
elites; actions exactly equal where the refit reads the elites alone (they
are the same host draws), atol 1e-5 under MPPI, whose soft-weighted mean
reads the scores too.
``GoalImController``'s fused path gets JAX's normals injected, as
``tests/test_torch_controller.py`` does, and its actions then agree to
1e-5."""

import jax
import numpy as np
import pytest

from test_controllers import AG_PARAMS, BASE_POLICY
from test_torch_controller import POLICY, PREDICTOR, _perturbed
from test_torch_planner import _jax_replan_draws
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import params_from_flax
from visual_foresight_torch.policy.cem_controllers import (GoalImController,
                                                           PixelCostController)
from visual_foresight_torch.policy.cem_controllers.samplers import (
    autograsp_sampler as t_ag, correlated_noise as t_cn,
    folding_sampler as t_fold, gaussian_sampler as t_gauss)
from visual_foresight_tpu.policy.cem_controllers.goal_im_controller import (
    GoalImController as JaxGoalIm)
from visual_foresight_tpu.policy.cem_controllers.pixel_cost_controller import (
    PixelCostController as JaxController)
from visual_foresight_tpu.policy.cem_controllers.samplers import (
    autograsp_sampler as j_ag, correlated_noise as j_cn,
    folding_sampler as j_fold, gaussian_sampler as j_gauss)

SCORE_RTOL = 1e-5
ACTION_ATOL = 1e-5
SEED = 5
AG_AGENT = dict(AG_PARAMS, adim=4, sdim=5)


class JaxOtherSampler(j_gauss.GaussianCEMSampler):
    """A subclass of the JAX package's Gaussian sampler."""


class OtherSampler(t_gauss.GaussianCEMSampler):
    """A subclass of the port's Gaussian sampler."""


SAMPLERS = {
    'gaussian': (j_gauss.GaussianCEMSampler, t_gauss.GaussianCEMSampler),
    'subclass': (JaxOtherSampler, OtherSampler),
    'mppi': (j_cn.CorrelatedNoiseSampler, t_cn.CorrelatedNoiseSampler),
    'autograsp': (j_ag.AutograspSampler, t_ag.AutograspSampler),
    'folding': (j_fold.FoldingCEMSampler, t_fold.FoldingCEMSampler),
}
# the RoboNet configs' MPPI policy (experiments/robonet/*: replan every 10,
# start planning at 5 with drawn warm-up actions, nactions 10 under T 15),
# cut to 16 samples, 4 actions under T 6 and replans every 3 steps
MPPI_POLICY = {'zeros_for_start_frames': False, 'start_planning': 2,
               'replan_interval': 3, 'nactions': 4, 'T': 6,
               'num_samples': 16, 'minimum_selection': 5, 'iterations': 2,
               'use_fused_planner': False, 'verbose': False,
               'predictor_hparams': PREDICTOR}
HOST = dict(POLICY, iterations=2, use_fused_planner=False)

# name -> (sampler, agent params, policy, latent_dim, act() steps); two CEM
# iterations a replan, the second from the first one's refit
HOST_CASES = {
    # the Gaussian sampler's defaults (rejection sampling), drawn warm-ups,
    # then a cold replan at t=2 and a warm one at t=4
    'gaussian_warm_starts_rejection_warmups': ('gaussian', AG_PARAMS, dict(
        {k: v for k, v in HOST.items() if k != 'rejection_sampling'},
        zeros_for_start_frames=False, start_planning=2), 0, 5),
    # a Gaussian subclass plans in the host loop with use_fused_planner on
    'gaussian_subclass': ('subclass', AG_PARAMS, dict(POLICY, iterations=2),
                          0, 2),
    # short plans (4 actions under T 6), the anchor, the covariance refit,
    # a latent predictor and the propagated distribution
    'mppi_anchor_refit_cov_latent': ('mppi', AG_AGENT, dict(
        MPPI_POLICY, smooth_across_last_action=True, refit_cov=True,
        predictor_propagation=True,
        predictor_hparams=dict(PREDICTOR, latent_dim=4)), 4, 6),
    'autograsp': ('autograsp', AG_AGENT, dict(
        {k: v for k, v in HOST.items()
         if k not in ('reuse_mean', 'reuse_cov', 'action_order')},
        z_thresh=0.0), 0, 2),
    'folding': ('folding', AG_AGENT, {
        'use_fused_planner': False, 'nactions': 6, 'T': 18,
        'num_samples': 16, 'minimum_selection': 6, 'replan_interval': 3,
        'iterations': 2, 'verbose': False, 'predictor_hparams': PREDICTOR},
        0, 2),
}


class _JaxDefaultLatent:
    """The port's predictor, handed at each call the latent that the JAX
    predictor draws without a key (``normal(PRNGKey(0), (M, latent_dim))``)."""

    def __init__(self, predictor, latent_dim):
        self._predictor, self._latent_dim = predictor, latent_dim

    def __call__(self, context, action_dict):
        m = len(action_dict['actions'])
        latent = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                              (m, self._latent_dim)))
        return self._predictor(context, action_dict, latent=latent)

    def __getattr__(self, name):
        return getattr(self._predictor, name)


def _with_sampler(policy, sampler, default):
    """``policy`` naming ``sampler`` (the key is left out for the default:
    an override equal to its default raises)."""
    return dict(policy) if sampler is default else \
        dict(policy, sampler=sampler)


def _pair(jcls, tcls, ag_params, jpolicy, tpolicy, latent_dim=0):
    """The JAX and the port controller on the same perturbed weights."""
    jctrl = jcls(ag_params, dict(jpolicy, seed=SEED))
    jctrl.predictor.set_params([_perturbed(p, 9 + c) for c, p in
                                enumerate(jctrl.predictor.params)])
    tctrl = tcls(ag_params, dict(tpolicy, seed=SEED, device='cpu'))
    tctrl.predictor.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                                for p in jctrl.predictor.params])
    if latent_dim:
        tctrl.predictor = _JaxDefaultLatent(tctrl.predictor, latent_dim)
    return jctrl, tctrl


def _frames(ag_params, steps, seed=3):
    rng = np.random.RandomState(seed)
    images = (rng.rand(steps + 1, 1, 16, 24, 3) * 255).astype(np.uint8)
    states = rng.randn(steps + 1, ag_params['sdim']).astype(np.float32) * 0.05
    return images, states


def _compare_step(t, got, want, exact):
    if exact:
        np.testing.assert_array_equal(got['actions'], want['actions'],
                                      err_msg='t={}'.format(t))
    else:
        np.testing.assert_allclose(got['actions'], want['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
    assert sorted(got['plan_stat']) == sorted(want['plan_stat'])
    for key, scores in want['plan_stat'].items():
        np.testing.assert_allclose(got['plan_stat'][key], scores,
                                   rtol=SCORE_RTOL, err_msg=key)


@pytest.mark.parametrize('case', sorted(HOST_CASES))
def test_pixel_cost_host_loop_matches_jax(case):
    sampler, ag_params, policy, latent_dim, steps = HOST_CASES[case]
    jsampler, tsampler = SAMPLERS[sampler]
    jctrl, tctrl = _pair(
        JaxController, PixelCostController, ag_params,
        _with_sampler(policy, jsampler, j_gauss.GaussianCEMSampler),
        _with_sampler(policy, tsampler, t_gauss.GaussianCEMSampler),
        latent_dim)
    assert tctrl._fused is None and jctrl._fused is None
    images, states = _frames(ag_params, steps)
    desig, goal = np.array([[[4, 6]]]), np.array([[[10, 18]]])
    np.random.seed(SEED)
    jctrl.reset()
    tctrl.reset()
    replans = 0
    for t in range(steps):
        kw = dict(t=t, i_tr=0, desig_pix=desig, goal_pix=goal,
                  images=images[:t + 2], state=states[:t + 2])
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        assert got['actions'].shape == (ag_params['adim'],)
        _compare_step(t, got, want, exact=sampler != 'mppi')
        if jctrl._t_since_replan == 0:
            replans += 1
            np.testing.assert_array_equal(tctrl._best_indices,
                                          jctrl._best_indices)
    assert replans == (2 if steps > 4 else 1)
    if policy.get('predictor_propagation'):
        np.testing.assert_allclose(tctrl._chosen_distrib,
                                   jctrl._chosen_distrib, atol=1e-4)
    if sampler == 'autograsp':
        assert set(np.unique(tctrl._best_actions[..., -1])) <= {-1.0, 1.0}


GOAL_POLICY = dict(BASE_POLICY, predictor_hparams=PREDICTOR,
                   num_samples=16, minimum_selection=7, iterations=2)


@pytest.mark.parametrize('fused', [True, False])
def test_goal_image_controller_matches_jax(fused):
    policy = GOAL_POLICY if fused else dict(GOAL_POLICY,
                                            use_fused_planner=False)
    jctrl, tctrl = _pair(JaxGoalIm, GoalImController, AG_PARAMS, policy,
                         policy)
    assert (tctrl._fused is not None) == fused == (jctrl._fused is not None)
    if fused:   # the port's replans draw the JAX controller's normals
        chain = {'rng': jax.random.PRNGKey(SEED)}
        replan, hp = tctrl._fused.replan, tctrl._hp
        spec = tctrl._fused.spec

        def injected(*args, generator, **kw):
            chain['rng'], sub = jax.random.split(chain['rng'])
            noise = _jax_replan_draws(sub, hp.iterations, hp.num_samples,
                                      spec.nactions * spec.adim)[0]
            return replan(*args, noise=noise, **kw)
        tctrl._fused.replan = injected
    images, states = _frames(AG_PARAMS, 3, seed=6)
    goal_image = np.random.RandomState(7).rand(1, 1, 16, 24, 3) \
        .astype(np.float32)
    np.random.seed(SEED)
    jctrl.reset()
    tctrl.reset()
    for t in range(3):
        kw = dict(t=t, i_tr=0, images=images[:t + 2],
                  goal_image=goal_image, state=states[:t + 2])
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        _compare_step(t, got, want, exact=not fused)
        np.testing.assert_array_equal(tctrl._best_indices,
                                      jctrl._best_indices)
    # the verbose dump (it raised until it was ported): the fused replan
    # dumps its last iteration, the host loop does not, as in JAX
    from test_torch_verbose import ListWorker
    worker = ListWorker()
    tctrl._hp.set_hparam('verbose', True)
    out = tctrl.act(verbose_worker=worker, **kw)
    assert np.isfinite(out['actions']).all()
    assert any(i[0] == 'txt_file' for i in worker.items) == fused
