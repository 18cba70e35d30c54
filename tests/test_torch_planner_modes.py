"""Port parity: ``FusedCEMPlanner`` against the JAX planner in each mode
the Gaussian sampler reaches (``REPLAN_CASES``), with JAX's normals (plan
noise, rejection rounds, latents) injected.  The check itself and its
tolerances are ``tests/test_torch_planner.py``'s
(``_check_replan_against_jax``): same elites, scores rtol 1e-4, mean and
sigma atol 1e-5, elite plans atol 1e-5 beside rtol 5e-5; chunked against
unchunked in the port: equal elites, plans and refit, scores rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import MODE_ACTION_RTOL, _check_replan_against_jax
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_tpu.planners import costs as jcosts
from visual_foresight_torch.planners import costs as tcosts


def _dispersed_cost(where, full):
    """The synthetic cost of ``tests/test_planner.py``'s penalty test in
    either framework: group 0's two copies score 0 and 10, group 1 scores 4
    throughout, everyone else 6 (ties, which the elite order must break by
    index)."""
    def cost(gen_images, gen_distribs, cost_ctx):
        m = gen_distribs.shape[0]
        row = np.arange(m)
        scores = np.full((m,), 6.0, np.float32)
        scores[row // 2 == 0] = np.where(row[row // 2 == 0] % 2 == 0, 0., 10.)
        scores[row // 2 == 1] = 4.0
        return full(scores) + 0.0 * where(gen_distribs)
    return cost


_JAX_DISPERSED = _dispersed_cost(lambda d: jnp.sum(d, axis=(1, 2, 3, 4, 5)),
                                 jnp.asarray)
_TORCH_DISPERSED = _dispersed_cost(lambda d: d.sum(dim=(1, 2, 3, 4, 5)),
                                   torch.tensor)
_GOAL = np.random.RandomState(8).rand(1, 16, 32, 3).astype(np.float32)

# name -> (planner modes, options of the check).  The refit covariance must
# keep full rank for the two frameworks to sample alike (ROADMAP.md, section
# 3): at least dim + 1 distinct elite plans, so the cases whose elites come
# in copies (stochastic_k) or span 8 dims (adim 4) take more samples and
# elites.
REPLAN_CASES = {
    'rejection': (dict(rejection_rounds=3), {}),
    'smooth_cov': (dict(smooth_cov=True), {}),
    'add_zero_action': (dict(add_zero_action=True), {}),
    'discrete_dims': (dict(discrete_dims=(2,)), {}),
    'everything_at_once': (dict(rejection_rounds=2, smooth_cov=True,
                                add_zero_action=True, discrete_dims=(2,),
                                blockdiag_refit=True), {}),
    'latent': ({}, dict(latent_dim=4)),
    'latent_two_cameras': ({}, dict(latent_dim=4, ncam=2)),
    'latent_adim4_sdim5': ({}, dict(latent_dim=4, adim=4, sdim=5, m=24,
                                    k_elite=12)),
    'stochastic_k_deterministic': (dict(stochastic_k=2),
                                   dict(m=32, k_elite=16)),
    'stochastic_k_latent': (dict(stochastic_k=2),
                            dict(latent_dim=4, m=32, k_elite=16)),
    'stochastic_k_latent_warm': (dict(stochastic_k=2),
                                 dict(latent_dim=4, m=32, k_elite=16,
                                      num_samples=24)),
    'stochastic_penalty_synthetic_cost': (
        dict(stochastic_k=2, stochastic_penalty=1.0),
        dict(cost_fn=(_JAX_DISPERSED, _TORCH_DISPERSED), iters=1,
             k_elite=4)),
    'stochastic_penalty_latent': (
        dict(stochastic_k=2, stochastic_penalty=1.0),
        dict(latent_dim=4, m=32, k_elite=8)),
    'cost_fn_goal_image_mse': ({}, dict(cost_fn=(
        lambda gi, gd, ctx: jcosts.goal_image_mse(gi, ctx),
        lambda gi, gd, ctx: tcosts.goal_image_mse(gi, ctx)),
        cost_ctx=_GOAL)),
    'sample_chunk': (dict(sample_chunk=8), dict(equals_unchunked=True)),
    'sample_chunk_latent': (dict(sample_chunk=8), dict(latent_dim=4)),
    'sample_chunk_stochastic_k': (dict(sample_chunk=16, stochastic_k=2),
                                  dict(m=32, k_elite=16,
                                       equals_unchunked=True)),
    'sample_chunk_fallback': (dict(sample_chunk=8),
                              dict(num_samples=12, equals_unchunked=True)),
}


@pytest.mark.parametrize('case', sorted(REPLAN_CASES))
def test_replan_modes_match_jax(case):
    """Each newly ported planner mode: same elites as the JAX planner,
    scores within ``REPLAN_RTOL``, mean and sigma within ``TOL``."""
    modes, opts = REPLAN_CASES[case]
    _check_replan_against_jax(modes=dict(modes),
                              action_rtol=MODE_ACTION_RTOL, **opts)
