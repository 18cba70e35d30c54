"""Port parity: ``PixelCostController`` with two cameras, the port's against
the JAX package's, side by side over a few ``act()`` steps on seeded small
models (one set of perturbed weights per camera): the fused planner on the
space-to-depth and on the classic backbone, and the host CEM loop.  Each
camera has its own frames, designated pixel and goal; the cost sums over
both views.

The fused path draws the JAX controller's normals
(``tests/test_torch_controller.py::_controllers``); the host loop samples
the same host draws on both sides (``tests/test_torch_host_loop.py``).

Tolerances: actions atol 1e-5, scores rtol 1e-4 with equal elites (the
planner's f32 tolerances)."""

import numpy as np
import pytest

from test_controllers import AG_PARAMS
from test_torch_controller import POLICY, PREDICTOR, _controllers
from test_torch_host_loop import HOST, SEED, _pair
from test_torch_weights_classic import few_torch_threads  # noqa: F401
from visual_foresight_torch.policy.cem_controllers import PixelCostController
from visual_foresight_tpu.policy.cem_controllers.pixel_cost_controller import (
    PixelCostController as JaxController)

ACTION_ATOL = 1e-5
SCORE_RTOL = 1e-4
NCAM = 2
AG2 = dict(AG_PARAMS, ncam=NCAM)
DESIG = np.array([[[4, 6]], [[9, 15]]])
GOAL = np.array([[[10, 18]], [[3, 5]]])


def _side_by_side(jctrl, tctrl, steps):
    """Both controllers over the same seeded two-camera frames; returns the
    number of replans."""
    rng = np.random.RandomState(8)
    images = (rng.rand(steps + 1, NCAM, 16, 24, 3) * 255).astype(np.uint8)
    states = (rng.randn(steps + 1, AG2['sdim']) * 0.01).astype(np.float32)
    np.random.seed(SEED)
    jctrl.reset()
    tctrl.reset()
    replans = 0
    for t in range(steps):
        kw = dict(t=t, i_tr=0, desig_pix=DESIG, goal_pix=GOAL,
                  images=images[:t + 2], state=states[:t + 2])
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        assert got['actions'].shape == (AG2['adim'],)
        np.testing.assert_allclose(got['actions'], want['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
        assert sorted(got['plan_stat']) == sorted(want['plan_stat'])
        for key, scores in want['plan_stat'].items():
            np.testing.assert_allclose(got['plan_stat'][key], scores,
                                       rtol=SCORE_RTOL, err_msg=key)
        if jctrl._t_since_replan == 0:
            replans += 1
            np.testing.assert_array_equal(tctrl._best_indices,
                                          jctrl._best_indices)
    return replans


@pytest.mark.parametrize('backbone', [4, 0], ids=['std', 'classic'])
def test_fused_controller_two_cameras_matches_jax(backbone):
    policy = dict(POLICY, iterations=2,
                  predictor_hparams=dict(PREDICTOR, std_factor=backbone))
    jctrl, tctrl = _controllers(AG2, policy)
    assert tctrl.predictor.n_cam == NCAM == len(tctrl.predictor.models)
    assert tctrl._fused is not None
    assert _side_by_side(jctrl, tctrl, 2) == 1          # a replan at t=1


def test_host_loop_controller_two_cameras_matches_jax():
    jctrl, tctrl = _pair(JaxController, PixelCostController, AG2, HOST, HOST)
    assert tctrl._fused is None and jctrl._fused is None
    assert len(tctrl.predictor.models) == NCAM
    assert _side_by_side(jctrl, tctrl, 2) == 1
