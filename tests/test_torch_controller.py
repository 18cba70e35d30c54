"""Port parity: ``visual_foresight_torch``'s ``PixelCostController`` against
the JAX package's, at ``tests/test_controllers.py``'s small configuration
with a space-to-depth predictor (the port's backbone), warm starts on
(``reuse_mean``/``reuse_cov``), ``replan_interval`` 2, 16 samples and 7
elites.  ``tests/test_torch_controller_modes.py`` runs the same comparison
under the campaigns' policies and the Gaussian sampler's other hparams.

Both controllers serve the same weights (the JAX controller's, carried over
by ``models/convert.py``), and each replan of the port gets the normals that
the JAX controller's key chain draws (its seed key, one split per replan,
then the replan's own splits: plan noise, rejection rounds, latents),
through a patched ``replan``.

Tolerances: actions atol 1e-5 and scores rtol 1e-4, the planner's f32
tolerances (``tests/test_torch_planner.py``), with equal elites."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_controllers import AG_PARAMS, BASE_POLICY, SMALL_PREDICTOR
from test_torch_planner import _jax_replan_draws
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import params_from_flax
from visual_foresight_torch.policy.cem_controllers import PixelCostController
from visual_foresight_tpu.policy.cem_controllers.pixel_cost_controller import (
    PixelCostController as JaxController)

ACTION_ATOL = 1e-5
SCORE_RTOL = 1e-4
PREDICTOR = dict(SMALL_PREDICTOR, std_factor=4, enc_features=(8, 16, 16),
                 lstm_kernel=3, separable_lstm=True)
# 7 elites: the refit covariance over the 6 plan dims (2 actions x 3) is
# then of full rank.  With fewer elites it is singular, and whether its
# Cholesky factor exists turns on rounding, which differs between XLA and
# torch (ROADMAP.md, section 3).
POLICY = dict(BASE_POLICY, predictor_hparams=PREDICTOR, reuse_mean=True,
              reuse_cov=True, num_samples=16, minimum_selection=7,
              replan_interval=2)
def _perturbed(params, seed, scale=0.1):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale)
        for x in leaves])


def _controllers(ag_params=AG_PARAMS, policy=POLICY):
    jctrl = JaxController(ag_params, dict(policy))
    tctrl = PixelCostController(ag_params, dict(policy, device='cpu'))
    tie_controllers(jctrl, tctrl, policy)
    return jctrl, tctrl


def tie_controllers(jctrl, tctrl, policy):
    """Perturb the JAX controller's weights (one seed a camera), give the
    port's controller the same, and make its replans draw the JAX
    controller's normals."""
    jctrl.predictor.set_params([_perturbed(p, 9 + c) for c, p in
                                enumerate(jctrl.predictor.params)])
    tctrl.predictor.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                                for p in jctrl.predictor.params])

    # the port's replans draw the JAX controller's normals
    chain = {'rng': jax.random.PRNGKey(policy.get('seed', 0))}
    replan = tctrl._fused.replan
    spec, hp = tctrl._fused.spec, tctrl._hp
    latent_dim = (policy['predictor_hparams'] or {}).get('latent_dim', 0)

    def injected(*args, generator, num_samples, **kw):
        chain['rng'], sub = jax.random.split(chain['rng'])
        chunk = hp.sample_chunk
        if not (chunk and num_samples > chunk and num_samples % chunk == 0):
            chunk = 0
        noise, latents, vis_latents = _jax_replan_draws(
            sub, hp.iterations, num_samples, spec.nactions * spec.adim,
            rejection_rounds=10 if hp.rejection_sampling else 0,
            stochastic_k=tctrl._fused._stoch_k, latent_dim=latent_dim,
            chunk=chunk, n_vis=min(10, hp.num_samples * tctrl._fused._stoch_k))
        return replan(*args, noise=noise, latents=latents,
                      vis_latents=vis_latents, num_samples=num_samples, **kw)
    tctrl._fused.replan = injected


def _run_side_by_side(jctrl, tctrl, ag_params, steps=5):
    """Both controllers over the same seeded frames; returns the lengths of
    ``scores_itr0`` step by step."""
    rng = np.random.RandomState(3)
    adim, sdim = ag_params['adim'], ag_params['sdim']
    images = (rng.rand(2, 1, 16, 24, 3) * 255).astype(np.uint8)
    state = rng.randn(2, sdim).astype(np.float32) * 0.01
    desig = np.array([[[4, 6]]])
    goal = np.array([[[10, 18]]])
    jctrl.reset()
    tctrl.reset()
    hist_i, hist_s = [images[0]], [state[0]]
    lengths = []
    for t in range(steps):
        hist_i.append(images[t % 2])
        hist_s.append(state[t % 2])
        kw = dict(t=t, i_tr=0, desig_pix=desig, goal_pix=goal,
                  images=np.stack(hist_i), state=np.stack(hist_s))
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        assert got['actions'].shape == (adim,)
        np.testing.assert_allclose(got['actions'], want['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
        assert sorted(got['plan_stat']) == sorted(want['plan_stat'])
        for key, scores in want['plan_stat'].items():
            np.testing.assert_allclose(got['plan_stat'][key], scores,
                                       rtol=SCORE_RTOL, err_msg=key)
        if 'scores_itr0' in got['plan_stat']:
            lengths.append(got['plan_stat']['scores_itr0'].shape[-1])
        np.testing.assert_array_equal(tctrl._best_indices,
                                      jctrl._best_indices)
    # the refit covariance that the next replan would shift (entries up to
    # the grasp variance, 4; centred sums lose relative bits)
    np.testing.assert_allclose(tctrl._fused_state[1].numpy(),
                               np.asarray(jctrl._fused_state[1]),
                               rtol=SCORE_RTOL, atol=ACTION_ATOL)
    return lengths


def test_controller_matches_jax_over_warm_started_steps():
    jctrl, tctrl = _controllers()
    # a replan at t=1 (cold, 16 samples) and at t=3 (warm, 8 samples)
    assert _run_side_by_side(jctrl, tctrl, AG_PARAMS) == [16, 16, 8, 8]


@pytest.mark.parametrize('override,where', [({}, 'verbose_worker')])
def test_unported_controller_options_raise(override, where):
    """The verbose plan dump was the one option not ported, and raised; it
    now writes through the worker it is given (other samplers and the host
    loop are held against JAX in ``tests/test_torch_host_loop.py`` and
    ``tests/test_torch_controller_samplers.py``; the dump's items against
    JAX's in ``tests/test_torch_verbose.py``)."""
    from test_torch_verbose import ListWorker
    policy = dict(POLICY, device='cpu', **override)
    policy.pop('verbose')            # the default, True: dump every replan
    ctrl = PixelCostController(AG_PARAMS, policy)
    ctrl.reset()
    worker = ListWorker()
    out = ctrl.act(t=1, i_tr=0, desig_pix=np.array([[[4, 6]]]),
                   goal_pix=np.array([[[10, 18]]]),
                   images=np.zeros((2, 1, 16, 24, 3), np.uint8),
                   state=np.zeros((2, 3), np.float32), **{where: worker})
    assert np.isfinite(out['actions']).all()
    assert [i[1] for i in worker.items if i[0] == 'txt_file'] == \
        ['planning_1_itr_2/plan.html']
