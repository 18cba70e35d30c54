"""Port parity: ``RegisterGtruthController`` and ``InvModelBaseController``,
the port's against the JAX package's side by side over a few ``act()``
steps at a small width, on the same perturbed weights (the predictor's, the
GDN's, the inverse net's):

- registration with two cameras, fused (the tradeoffs, the registered
  designated pixels, the weighted distance grids) and in the host CEM loop
  (the weighted cost), and with the pixels of several objects, at one
  pixel and over a region;
- the inverse-model controller's actions, its warm-up draws included.

Draws and tolerances as in ``tests/test_torch_controller_variants.py``:
actions atol 1e-5, scores and tradeoffs rtol 1e-4 with equal elites."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_controllers import AG_PARAMS
from test_torch_aux_models import seeded
from test_torch_controller_variants import (ACTION_ATOL, POLICY, SCORE_RTOL,
                                            _goal_image, inject_jax_draws,
                                            side_by_side)
from test_torch_host_loop import SEED, _frames, _pair
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_controller import PREDICTOR
from visual_foresight_torch.models.convert import load_flax_params
from visual_foresight_torch.policy.cem_controllers.registration_controller \
    import RegisterGtruthController
from visual_foresight_torch.policy.inverse_models. \
    inverse_model_base_controller import InvModelBaseController
from visual_foresight_tpu.policy.cem_controllers import \
    registration_controller as jreg
from visual_foresight_tpu.policy.inverse_models import \
    inverse_model_base_controller as jinv


# -- registration -------------------------------------------------------------------
REG_POLICY = dict(POLICY, predictor_hparams=dict(PREDICTOR))


def _registration_pair(ncam, policy):
    ag = dict(AG_PARAMS, ncam=ncam, ntask=1)
    jctrl, tctrl = _pair(jreg.RegisterGtruthController,
                         RegisterGtruthController, ag, policy, policy)
    tree = seeded(jctrl.gdn_params, 22)
    jctrl.gdn_params = jax.tree.map(jnp.asarray, tree)
    load_flax_params(tctrl.gdn, tree)
    assert not tctrl.gdn_restored
    assert tctrl._n_desig == jctrl._n_desig == 2
    return jctrl, tctrl


def _check_registration(jctrl, tctrl):
    np.testing.assert_array_equal(tctrl._desig_pix, jctrl._desig_pix)
    np.testing.assert_allclose(tctrl.reg_tradeoff, jctrl.reg_tradeoff,
                               rtol=SCORE_RTOL)
    np.testing.assert_allclose(tctrl._cost_grids().numpy(),
                               np.asarray(jctrl._cost_grids()),
                               rtol=SCORE_RTOL, atol=1e-5)
    assert abs(tctrl.reg_tradeoff.sum() - tctrl._n_desig / 2) < 1e-6


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'host_loop'])
def test_registration_two_cameras_matches_jax(fused):
    policy = REG_POLICY if fused else dict(REG_POLICY,
                                           use_fused_planner=False)
    jctrl, tctrl = _registration_pair(2, policy)
    if fused:
        inject_jax_draws(tctrl)
    rng = np.random.RandomState(9)
    images = (rng.rand(4, 2, 16, 24, 3) * 255).astype(np.uint8)
    states = (rng.randn(4, 3) * 0.05).astype(np.float32)
    assert side_by_side(
        jctrl, tctrl, 3, images, states, check=_check_registration,
        desig_pix=np.array([[[8, 12]], [[5, 20]]]),
        goal_pix=np.array([[[4, 20]], [[11, 3]]]),
        goal_image=_goal_image(2, 10)) == 2


@pytest.mark.parametrize('region', [False, True], ids=['pixel', 'region'])
def test_registration_multi_object_pixels_matches_jax(region):
    policy = dict(REG_POLICY, use_fused_planner=False)
    if region:
        policy['register_region'] = True
    jctrl, tctrl = _registration_pair(1, policy)
    images, states = _frames(AG_PARAMS, 2, seed=11)
    assert side_by_side(
        jctrl, tctrl, 2, images, states, check=_check_registration,
        desig_pix=np.array([[[8, 12], [3, 4], [10, 20]]]),
        goal_pix=np.array([[[4, 20], [5, 5], [11, 21]]]),
        goal_image=_goal_image(1, 12)) == 1
    np.testing.assert_array_equal(tctrl._goal_pix_sel, [[[4, 20]]])


# -- the inverse model ------------------------------------------------------------
INV_AG = {'adim': 3, 'sdim': 3, 'image_height': 16, 'image_width': 24}
INV_POLICY = {'T': 10, 'context_action_weight': [1, 1, 1],
              'initial_action_low': [-0.025, -0.025, 0.],
              'initial_action_high': [0.025, 0.025, 0.]}


def test_inverse_model_controller_matches_jax(tmp_path):
    missing = str(tmp_path / 'no_checkpoint')
    jctrl = jinv.InvModelBaseController(
        INV_AG, dict(INV_POLICY, model_params_path=missing))
    tree = seeded(jctrl.predictor._params, 23)
    jctrl.predictor._params = jax.tree.map(jnp.asarray, tree)
    with pytest.warns(UserWarning, match='seeded random weights'):
        tctrl = InvModelBaseController(INV_AG, dict(
            INV_POLICY, model_params_path=missing, device='cpu'))
    assert not tctrl.predictor.restored
    load_flax_params(tctrl.predictor.net, tree)
    rng = np.random.RandomState(13)
    frames = rng.randint(0, 255, (8, 1, 1, 16, 24, 3), np.uint8)
    goal = rng.randint(0, 255, (1, 1, 16, 24, 3), np.uint8)
    runs = []
    for ctrl in (jctrl, tctrl):
        np.random.seed(SEED)
        ctrl.reset()
        runs.append([ctrl.act(t=t, i_tr=0, images=frames[t],
                              goal_image=goal)['actions']
                     for t in range(8)])
    want, got = runs
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (3,)
        np.testing.assert_allclose(g, w, atol=ACTION_ATOL,
                                   err_msg='t={}'.format(t))
    # past the two warm-up steps the plan comes from the network
    assert np.abs(np.asarray(got[2:])).max() > 0.1
    # the network on the same inputs, outside the controller
    cur = frames[5, -1, 0].astype(np.float32) / 255.0
    g0 = goal[-1, 0].astype(np.float32) / 255.0
    ctx = np.stack([frames[3, -1, 0], frames[4, -1, 0]])[None].astype(
        np.float32) / 255.0
    np.testing.assert_allclose(
        tctrl.predictor(cur, g0, None, ctx),
        jctrl.predictor(cur, g0, None, ctx), atol=ACTION_ATOL)
