"""Port parity: ``PixelCostController`` against the JAX package's under the
policies of the two grasp-transport campaigns
(``benchmarks/ag_bench20*/hparams.py``: adim 4, sdim 5, a latent predictor,
``predictor_propagation``; the hard set's ``stochastic_planning`` with
``stochastic_penalty``) and under the Gaussian sampler's other hparams, each
at a small width.  The side-by-side run, the injection of JAX's normals and
latents and the tolerances are ``tests/test_torch_controller.py``'s."""

import numpy as np
import pytest

from test_controllers import AG_PARAMS
from test_torch_controller import (POLICY, PREDICTOR, _controllers,
                                   _run_side_by_side)
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.policy.cem_controllers import PixelCostController

# the grasp-transport campaigns: (x, y, z, theta) deltas, a 5-dim state and
# one latent per sample; the sampling widths of ag_bench20's policy.  8 plan
# dims, so the default 10 elites keep the refit at full rank
AG_AGENT = dict(AG_PARAMS, adim=4, sdim=5)
AG_POLICY = {
    'initial_std': 0.04, 'initial_std_rot': np.pi / 32,
    'initial_std_lift': 0.6, 'rejection_sampling': False,
    'replan_interval': 2, 'predictor_propagation': True, 'num_samples': 24,
    'nactions': 2, 'T': 6, 'verbose': False,
    'predictor_hparams': dict(PREDICTOR, latent_dim=4)}
# name -> (agent params, policy, scores_itr0 lengths over steps 1-4)
CONTROLLER_CASES = {
    'ag_bench20': (AG_AGENT, AG_POLICY, [24, 24, 24, 24]),
    # ag_bench20_hard's lever, warm-started: 19 x 2 = 38 rows cold; warm
    # int(38 / 2) = 19, rounded up to 20 to keep both copies of every plan;
    # 9 elites among the 10 unique plans of a warm replan
    'ag_bench20_hard_warm': (AG_AGENT, dict(
        AG_POLICY, stochastic_planning=(2,), stochastic_penalty=1.0,
        num_samples=19, minimum_selection=9, reuse_mean=True,
        reuse_cov=True), [38, 38, 20, 20]),
    'stochastic_planning_alone': (AG_AGENT, dict(
        AG_POLICY, stochastic_planning=(2,), num_samples=18,
        minimum_selection=18), [36, 36, 36, 36]),
    # GaussianCEMSampler's defaults (rejection_sampling stays True)
    'default_rejection_sampling': (AG_PARAMS, dict(
        {k: v for k, v in POLICY.items() if k != 'rejection_sampling'},
        smooth_cov=True, add_zero_action=True), [16, 16, 8, 8]),
    'discrete_ind': (AG_PARAMS, dict(POLICY, discrete_ind=[2]),
                     [16, 16, 8, 8]),
    # chunks of 12 over 24 samples; the warm replan's 12 run unchunked.  The
    # default 10 elites: the JAX planner's chunked vis re-roll needs k_elite >= n_vis
    'sample_chunk': (AG_PARAMS, dict(
        {k: v for k, v in POLICY.items() if k != 'minimum_selection'},
        num_samples=24, sample_chunk=12),
                     [24, 24, 12, 12]),
    'sample_chunk_latent': (AG_AGENT, dict(AG_POLICY, sample_chunk=12),
                            [24, 24, 24, 24]),
}


@pytest.mark.parametrize('case', sorted(CONTROLLER_CASES))
def test_controller_modes_match_jax(case):
    """The campaigns' policies and the Gaussian sampler's other hparams
    through both controllers: a cold replan at t=1 and a second one at t=3
    (warm where the policy reuses, and on the propagated distribution where
    it propagates)."""
    ag_params, policy, want_lengths = CONTROLLER_CASES[case]
    jctrl, tctrl = _controllers(ag_params, policy)
    assert _run_side_by_side(jctrl, tctrl, ag_params) == want_lengths
    if policy.get('predictor_propagation'):
        np.testing.assert_allclose(tctrl._chosen_distrib,
                                   jctrl._chosen_distrib, atol=1e-4)


def test_controller_builds_with_the_sampler_defaults_and_campaign_policies():
    """``GaussianCEMSampler``'s own defaults (``rejection_sampling`` True)
    and the policy values of ag_bench20 and ag_bench20_hard (768 samples,
    10 actions x 3, replan every 10, K = 2 copies with penalty 1.0) build a
    controller whose planner holds them."""
    base = {'device': 'cpu', 'predictor_hparams': dict(PREDICTOR,
                                                       latent_dim=8)}
    ctrl = PixelCostController(AG_AGENT, dict(base))
    assert ctrl._hp.rejection_sampling is True
    assert ctrl._fused._rej == 10
    campaign = {'initial_std': 0.04, 'initial_std_rot': np.pi / 32,
                'rejection_sampling': False, 'replan_interval': 10,
                'predictor_propagation': True, 'num_samples': 768,
                'nactions': 10, 'T': 30, 'initial_std_lift': 0.6}
    ctrl = PixelCostController(AG_AGENT, dict(base, **campaign))
    assert (ctrl._fused._M, ctrl._fused._rej, ctrl._fused.spec.nactions) == \
        (768, 0, 10)
    assert ctrl._fused.spec.per_dim_std == (0.04, 0.04, 0.6, np.pi / 32)
    hard = PixelCostController(AG_AGENT, dict(
        base, stochastic_planning=(2,), stochastic_penalty=1.0, **campaign))
    assert (hard._fused._M, hard._fused._stoch_k,
            hard._fused._stoch_penalty) == (1536, 2, 1.0)
