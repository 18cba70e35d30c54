"""Port parity: ``PixelCostController`` on its fused path under the other
samplers -- ``CorrelatedNoiseSampler`` (MPPI, anchored on the last executed
action, after drawn warm-up actions as the RoboNet policies have them),
``AutograspSampler``, ``AutograspEpsilon`` and ``FoldingCEMSampler`` --
against the JAX package's controller, side by side at a small width.

Each replan of the port gets the draws of the JAX controller's key chain
(``tests/test_torch_planner_samplers.py::jax_mode_draws``); the warm-up
actions come from the host samplers (``np.random.seed`` against the port's
``RandomState``).  The folding cases factor through one continuous function
on both sides, as that file explains.

Tolerances: actions atol 1e-5, scores rtol 1e-5 (f32, small model), equal
elites."""

import importlib.util
import os

import jax
import numpy as np
import pytest

from test_controllers import AG_PARAMS
from test_torch_controller import PREDICTOR
from test_torch_host_loop import SAMPLERS, SEED, _compare_step, _frames, _pair
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_planner_samplers import (_ridge_factor_jax,
                                         _ridge_factor_torch, jax_mode_draws)
from visual_foresight_torch.planners import gaussian as tgauss
from visual_foresight_torch.policy.cem_controllers import PixelCostController
from visual_foresight_torch.policy.cem_controllers.samplers import (
    autograsp_epsilon as t_age)
from visual_foresight_tpu.planners import gaussian as jgauss
from visual_foresight_tpu.policy.cem_controllers.pixel_cost_controller import (
    PixelCostController as JaxController)
from visual_foresight_tpu.policy.cem_controllers.samplers import (
    autograsp_epsilon as j_age)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AG_AGENT = dict(AG_PARAMS, adim=4, sdim=5)
SAMPLERS = dict(SAMPLERS, ag_epsilon=(j_age.AutograspEpsilon,
                                      t_age.AutograspEpsilon))
BASE = {'num_samples': 16, 'iterations': 2, 'verbose': False,
        'predictor_hparams': PREDICTOR}
# Gaussian base plans: 2 actions x repeat 3, one elite more than plan dims
GAUSS = dict(BASE, nactions=2, T=6, rejection_sampling=False,
             replan_interval=2)

# name -> (sampler, policy, latent_dim, act() steps, scores_itr0 lengths of
# the replans)
CASES = {
    # MPPI at control cadence (nactions == T) after drawn warm-ups, the
    # chain anchored on the last executed action, the covariance refit
    'mppi_anchor_refit_cov_latent': ('mppi', dict(
        BASE, nactions=4, T=4, minimum_selection=5,
        zeros_for_start_frames=False, start_planning=2, replan_interval=3,
        smooth_across_last_action=True, refit_cov=True, kappa=5.0,
        predictor_hparams=dict(PREDICTOR, latent_dim=4)), 4, 6, [16, 16]),
    # rejection sampling, the resample from the elites, deviations; the
    # warm mean drops the derived grip dim: 8 samples when warm
    'autograsp_warm_resample': ('autograsp', dict(
        {k: v for k, v in GAUSS.items() if k != 'rejection_sampling'},
        minimum_selection=7, z_thresh=0.0, reuse_mean=True, reuse_cov=True,
        no_refit=False, deviation_prob=0.2), 0, 4, [16, 8]),
    'ag_epsilon': ('ag_epsilon', dict(
        GAUSS, num_samples=24, minimum_selection=12, ag_zthresh=0.0,
        action_order=['x', 'y', 'z', 'grasp']), 0, 2, [24]),
    'folding': ('folding', dict(BASE, num_samples=48, minimum_selection=24,
                                replan_interval=3), 0, 2, [48]),
}


def _inject(tctrl, latent_dim):
    """The port's replans draw the JAX controller's key chain."""
    planner = tctrl._fused
    modes = {name: cfg for name, cfg in (
        ('mppi', planner._mppi), ('autograsp', planner._ag),
        ('ag_epsilon', planner._ag_eps), ('folding', planner._folding))
        if cfg}
    modes['rejection_rounds'] = planner._rej
    chain = {'rng': jax.random.PRNGKey(SEED)}
    replan = planner.replan

    def injected(*args, generator, num_samples, **kw):
        chain['rng'], sub = jax.random.split(chain['rng'])
        noise, latents = jax_mode_draws(sub, tctrl._hp.iterations,
                                        num_samples, planner.spec, modes,
                                        latent_dim)
        return replan(*args, noise=noise, latents=latents,
                      num_samples=num_samples, **kw)
    planner.replan = injected


@pytest.mark.parametrize('case', sorted(CASES))
def test_fused_controller_samplers_match_jax(case, monkeypatch):
    sampler, policy, latent_dim, steps, want_lengths = CASES[case]
    if sampler == 'folding':
        monkeypatch.setattr(jgauss, '_psd_factor', _ridge_factor_jax)
        monkeypatch.setattr(tgauss, '_psd_factor', _ridge_factor_torch)
    jsampler, tsampler = SAMPLERS[sampler]
    jctrl, tctrl = _pair(JaxController, PixelCostController, AG_AGENT,
                         dict(policy, sampler=jsampler),
                         dict(policy, sampler=tsampler))
    assert tctrl._fused is not None and jctrl._fused is not None
    assert tctrl._fused.is_mppi == (sampler == 'mppi')
    _inject(tctrl, latent_dim)
    images, states = _frames(AG_AGENT, steps)
    desig, goal = np.array([[[4, 6]]]), np.array([[[10, 18]]])
    np.random.seed(SEED)
    jctrl.reset()
    tctrl.reset()
    lengths = []
    for t in range(steps):
        kw = dict(t=t, i_tr=0, desig_pix=desig, goal_pix=goal,
                  images=images[:t + 2], state=states[:t + 2])
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        assert got['actions'].shape == (4,)
        _compare_step(t, got, want, exact=False)
        if jctrl._t_since_replan == 0:
            lengths.append(got['plan_stat']['scores_itr0'].shape[-1])
            np.testing.assert_array_equal(tctrl._best_indices,
                                          jctrl._best_indices)
    assert lengths == want_lengths
    if sampler == 'autograsp':
        assert set(np.unique(tctrl._best_actions[..., -1])) <= {-1.0, 1.0}


def test_fused_mppi_needs_nactions_equal_to_t(tmp_path):
    """The RoboNet policies leave ``T`` at 15 with 10 actions
    (``experiments/robonet/view_generalization/single_view.py``, here with
    a small predictor): the JAX package asserts ``nactions == T`` for fused
    MPPI, the port raises, and both plan such a policy only in the host
    loop."""
    spec = importlib.util.spec_from_file_location('single_view', os.path.join(
        REPO, 'experiments', 'robonet', 'view_generalization',
        'single_view.py'))
    config = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(config)
    policy = {k: v for k, v in config.policy.items() if k != 'type'}
    policy.update(model_path=str(tmp_path), predictor_hparams=PREDICTOR)
    assert (policy['nactions'], policy['sampler']) == \
        (10, SAMPLERS['mppi'][0])
    with pytest.raises(AssertionError):
        JaxController(AG_AGENT, dict(policy))
    policy.update(sampler=SAMPLERS['mppi'][1], device='cpu')
    with pytest.raises(ValueError, match='nactions'):
        PixelCostController(AG_AGENT, policy)
    host = PixelCostController(AG_AGENT, dict(policy,
                                              use_fused_planner=False))
    assert host._fused is None and host._hp.T == 15
