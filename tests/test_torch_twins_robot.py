"""The robot and RoboNet experiment twins against the JAX configs they
copy, on the CPU.

- Each of the 22 twins (the five sawyer experiments of
  ``experiments/sawyer`` and the 17 RoboNet configs of
  ``experiments/robonet``): its tree equals its source's, and its policy
  builds beside the JAX one with the same hparams, or raises where the JAX
  one does (``test_torch_twins.py``'s checks).  As written, the towel
  classifier's ``state_append`` is a key neither classifier controller
  declares (``KeyError``), and the RoboNet MPPI configs' 10 actions under
  the default ``T`` of 15 stop the fused planner (the port's
  ``ValueError``, the JAX package's assert); without the key, or with
  ``use_fused_planner`` off, both build.
- One RoboNet MPPI twin (``robonet_franka``, cut to 12 samples, T 7 for
  the agent, 16x24 frames, a small predictor, ``use_fused_planner`` off)
  through the port's ``run_robot`` beside the JAX ``run_robot`` on its
  source, on ``chip_smoke.FakeArm`` and the port's camera node: the same
  weights, the port's host draws taken from the global ``np.random`` as
  JAX's are; actions and states within 1e-5.
- ``RegisterGtruthController`` at 96x128, the sawyer registration
  experiment's size, beside the JAX one: two cameras, ``register_region``,
  the GDN and the predictor on the same weights (the JAX package's,
  perturbed, converted) at small widths, JAX's draws injected: designated
  pixels equal, tradeoffs and cost grids within 1e-5, scores rtol 1e-4
  with the same elites.  At this size the controller registers over a
  window of 5 pixels each side (2 below 96 rows).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import test_torch_run_robot
from test_controllers import AG_PARAMS
from test_torch_aux_models import seeded
from test_torch_controller_registration import (REG_POLICY,
                                                _check_registration)
from test_torch_controller_variants import inject_jax_draws, side_by_side
from test_torch_host_loop import _pair
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_run_robot import cameras  # noqa: F401
from test_torch_twins import (AG, MODEL, check_twin_policy,
                              check_twin_tree)
from visual_foresight_torch.models.convert import load_flax_params
from visual_foresight_torch.policy.cem_controllers.registration_controller \
    import RegisterGtruthController
from visual_foresight_tpu.policy.cem_controllers import \
    registration_controller as jreg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTION_ATOL = 1e-5
SAWYER_AG, SAWYER_AG2 = (4, 5, 1), (4, 5, 2)
INV = [('policy', 'model_params_path'), ('policy', 'model_restore_path')]
ROBONET = 'experiments/robonet/'
# twin -> (source, (adim, sdim, ncam) of its env, the paths of the default
# weights, departures): as test_torch_twins.TWINS
ROBOT_TWINS = {
    'robot_sawyer_human_cem': ('experiments/sawyer/human_cem/hparams.py',
                               SAWYER_AG2, [MODEL], []),
    'robot_sawyer_registration_experiments': (
        'experiments/sawyer/registration_experiments/hparams.py', SAWYER_AG2,
        [MODEL, ('policy', 'gdn_path')], []),
    'robot_sawyer_towel_classifier': (
        'experiments/sawyer/towel_classifier/hparams.py', SAWYER_AG,
        [MODEL, ('policy', 'classifier_path')], []),
    'robot_sawyer_mixed_objects_deformable': (
        'experiments/sawyer/mixed_objects/hparams_deformable_objects.py',
        SAWYER_AG2, [MODEL], []),
    'robot_sawyer_mixed_objects_hardobjects': (
        'experiments/sawyer/mixed_objects/hparams_hardobjects.py',
        SAWYER_AG2, [MODEL], []),
    'robonet_pixel_cost': (ROBONET + 'pixel_cost/hparams.py', AG, [MODEL],
                           []),
}
MPPI_TWINS = {
    'robonet_baxter_fine_tune': 'baxter_fine_tune/baxter_fine_tune.py',
    'robonet_baxter_fine_tune_baxter_scratch':
        'baxter_fine_tune/baxter_scratch.py',
    'robonet_baxter_fine_tune_sawyer_baxter_fine_tune':
        'baxter_fine_tune/sawyer_baxter_fine_tune.py',
    'robonet_franka': 'franka/franka.py',
    'robonet_new_bin_inlay_all_robots': 'new_bin_inlay/all_robots.py',
    'robonet_new_bin_inlay_sawyer_only': 'new_bin_inlay/sawyer_only.py',
    'robonet_robotiq_fine_tune_start_all': 'robotiq/fine_tune_start_all.py',
    'robonet_robotiq_fine_tune_start_sawyer':
        'robotiq/fine_tune_start_sawyer.py',
    'robonet_robotiq_from_scratch': 'robotiq/from_scratch.py',
    'robonet_robotiq_zero_shot': 'robotiq/zero_shot.py',
    'robonet_view_generalization_all_views': 'view_generalization/'
                                             'all_views.py',
    'robonet_view_generalization_single_view': 'view_generalization/'
                                               'single_view.py',
}
ROBOT_TWINS.update({name: (ROBONET + src, AG, [MODEL], [])
                    for name, src in MPPI_TWINS.items()})
ROBOT_TWINS.update({
    'robonet_inverse_model_' + f: (ROBONET + 'inverse_model/' + f + '.py',
                                   AG, INV, [])
    for f in ('franka_inverse_conf', 'multibot_one_step', 'sawyer_one_step',
              'sawyer_two_step')})
# how each source's policy raises as written, from chip_smoke's table of
# the twins: the overrides equal to their defaults
# (Policy._override_defaults raises on the first in the dict), the keys no
# controller of either package declares, the fused planner's refusal
POINTS = {p[0]: p for p in chip_smoke.ROBOT_TWIN_POINTS}


@pytest.mark.parametrize('name', sorted(ROBOT_TWINS))
def test_robot_twin_tree_equals_its_source(name):
    check_twin_tree(name, ROBOT_TWINS)


@pytest.mark.parametrize('name', sorted(ROBOT_TWINS))
def test_robot_twin_policy_builds_as_jax_does(name, tmp_path):
    _, _, raises, key_raises, refusal = POINTS[name]
    check_twin_policy(name, ROBOT_TWINS, str(tmp_path), raises=raises,
                      key_raises=key_raises,
                      fused_raises=refusal and re.escape(refusal))



# -- the sawyer registration experiment's controller at 96x128 ---------------
REG96_AG = dict(AG_PARAMS, image_height=96, image_width=128, ncam=2, ntask=1)
REG_ATOL = 1e-5


def _check_registration_96(jctrl, tctrl):
    """``test_torch_controller_registration``'s check, and the tradeoffs
    and weighted grids within 1e-5."""
    _check_registration(jctrl, tctrl)
    np.testing.assert_allclose(tctrl.reg_tradeoff, jctrl.reg_tradeoff,
                               rtol=0, atol=REG_ATOL)
    np.testing.assert_allclose(tctrl._cost_grids().numpy(),
                               np.asarray(jctrl._cost_grids()), rtol=0,
                               atol=REG_ATOL * float(np.abs(np.asarray(
                                   jctrl._cost_grids())).max()))


def test_registration_at_96x128_matches_jax():
    """The sawyer registration experiment's frame size (96x128: each
    registration averages a window of 5 pixels each side, 2 below 96 rows)
    and ``register_region``, two cameras, fused, the JAX controller's draws
    injected, the same perturbed weights at small widths: the registered
    designated pixels equal, tradeoffs and grids within 1e-5, actions
    within 1e-5, scores rtol 1e-4 with the same elites."""
    policy = dict(REG_POLICY, register_region=True)
    jctrl, tctrl = _pair(jreg.RegisterGtruthController,
                         RegisterGtruthController, REG96_AG, policy, policy)
    tree = seeded(jctrl.gdn_params, 22)
    jctrl.gdn_params = jax.tree.map(jnp.asarray, tree)
    load_flax_params(tctrl.gdn, tree)
    assert tctrl._img_height == jctrl._img_height == 96
    assert tctrl._n_desig == jctrl._n_desig == 2
    inject_jax_draws(tctrl)
    rng = np.random.RandomState(19)
    images = (rng.rand(4, 2, 96, 128, 3) * 255).astype(np.uint8)
    states = (rng.randn(4, 3) * 0.05).astype(np.float32)
    goal_image = rng.rand(1, 2, 96, 128, 3).astype(np.float32)
    assert side_by_side(
        jctrl, tctrl, 3, images, states, check=_check_registration_96,
        desig_pix=np.array([[[40, 60]], [[70, 30]]]),
        goal_pix=np.array([[[20, 100]], [[60, 90]]]),
        goal_image=goal_image) == 2


# -- a RoboNet MPPI twin through run_robot -----------------------------------
# robonet_franka and its source cut to a small size: 12 samples, 2
# iterations, T 7 (warm-up draws to t=4, one replan at t=5), 16x24 frames,
# a small predictor, use_fused_planner off (the fused planner refuses 10
# actions under T 15 in both packages)
RUN_CUT = {'agent': {'T': 7, 'image_height': 16, 'image_width': 24},
           'policy': {'num_samples': 12, 'iterations': 2, 'verbose': False,
                      'use_fused_planner': False, 'seed': 5,
                      'predictor_hparams': dict(test_torch_run_robot.PREDICTOR,
                                                adim=4, sdim=5)}}


def _robonet_config(side, root, arm):
    """The franka twin (port) or its source (JAX), cut (``RUN_CUT``), on
    the fake arm and the camera node's first channel, results under
    ``root``."""
    import copy
    from visual_foresight_torch.sim import run as t_run
    from visual_foresight_tpu.sim import run as j_run
    path = chip_smoke.ROBONET_ROBOT_TWIN if side == 'port' else os.path.join(
        REPO, ROBONET + 'franka/franka.py')
    load = t_run.load_config if side == 'port' else j_run.load_config
    config = copy.deepcopy(load(path))
    env = config['agent']['env'][1]
    env.update(robot_name=chip_smoke.ROBOT_NAME, robot_type=arm,
               save_video=False,
               camera_topics=test_torch_run_robot.topics(side)[:1])
    config['agent'].update(data_save_dir=str(root), **RUN_CUT['agent'])
    config['policy'].update(RUN_CUT['policy'],
                            model_path=os.path.join(str(root), 'none'))
    if side == 'port':
        config['policy']['device'] = 'cpu'
    config['end_index'] = 0
    return config


def _run(side, robot):
    """``robot`` run with scripted clicks and prompts and seeded frames
    (``test_torch_run_robot``'s); returns (clicks, prompts, the raw
    trajectory's pickles), read before the file worker stops."""
    import pickle
    from unittest import mock
    classes = test_torch_run_robot.SIDES[side]
    clicks = chip_smoke.ScriptedClicks(chip_smoke.ROBOT_CLICK_SEED)
    prompts = chip_smoke.ScriptedPrompts()
    np.random.seed(test_torch_run_robot.ENV_SEED)
    with mock.patch.object(classes['base'], 'select_points', clicks), \
            mock.patch('builtins.input', prompts), \
            mock.patch.object(classes['rec'].CameraRecorder, 'get_image',
                              test_torch_run_robot.frame_feed()):
        robot.run()
    folder = os.path.join(robot.agentparams['data_save_dir'], 'raw',
                          'traj_group0', 'traj0')
    raw = {}
    for name in ('agent_data', 'obs_dict', 'policy_out'):
        with open(os.path.join(folder, name + '.pkl'), 'rb') as f:
            raw[name] = pickle.load(f)
    raw['jpgs'] = sorted(os.listdir(os.path.join(folder, 'images0')))
    robot.agent.cleanup()
    robot.agent.env.close()
    return clicks, prompts, raw


def test_robonet_mppi_twin_run_robot_matches_jax(cameras, tmp_path):
    """``robonet_franka`` through the port's ``run_robot`` beside its source
    through the JAX ``run_robot``: the same weights (the JAX controller's,
    perturbed, converted), the port's host draws taken from the global
    ``np.random`` that the JAX package draws from; one trajectory with the
    warm-up draws and a replan: actions and states within 1e-5, the same
    stats and elites."""
    from visual_foresight_torch.sim import run_robot as t_robot
    from visual_foresight_tpu.sim import run_robot as j_robot
    from test_torch_controller import _perturbed
    from visual_foresight_torch.models.convert import params_from_flax
    robots = {}
    with pytest.warns(UserWarning, match='seeded'):
        for side, module in (('jax', j_robot), ('port', t_robot)):
            robots[side] = module.RobotEnvironment(
                _robonet_config(side, tmp_path / side,
                                test_torch_run_robot.QuickArm),
                benchmark=True)
    jctrl, tctrl = robots['jax'].policy, robots['port'].policy
    assert jctrl._fused is None and tctrl._fused is None
    jctrl.predictor.set_params([_perturbed(p, 9 + c) for c, p in
                                enumerate(jctrl.predictor.params)])
    tctrl.predictor.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                                for p in jctrl.predictor.params])
    # the JAX package's host draws come from the global stream (the reset
    # of each trajectory hands it to the port's sampler)
    tctrl._np_rng = np.random.mtrand._rand
    out = {side: _run(side, robots[side]) for side in ('jax', 'port')}
    got, want = out['port'][2], out['jax'][2]
    for key in ('state', 'qpos'):
        np.testing.assert_allclose(got['obs_dict'][key], want['obs_dict'][key],
                                   atol=ACTION_ATOL, err_msg=key)
    assert len(got['policy_out']) == len(want['policy_out']) == 7
    for t, (g, w) in enumerate(zip(got['policy_out'], want['policy_out'])):
        np.testing.assert_allclose(g['actions'], w['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
    for key, value in want['agent_data']['stats'].items():
        assert float(got['agent_data']['stats'][key]) == float(value), key
    np.testing.assert_array_equal(tctrl._best_indices, jctrl._best_indices)
    assert out['port'][1].seen == out['jax'][1].seen
    assert got['jpgs'] == want['jpgs'] and len(got['jpgs']) == 8
