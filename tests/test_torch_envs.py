"""Port parity: the cartgripper envs, ``visual_foresight_torch``'s against the
JAX package's.

- From the vendored reset states (``xz_lifting_bench20`` tasks 0 and 1 in
  ``CartgripperXZGrasp``, ``ag_bench20`` task 0 in
  ``AutograspCartgripperEnv``, each with its campaign's env params) and one
  seeded action sequence, every observation of the reset and of each step
  is equal: the rendered frames bit for bit, states, joint and object
  poses, ``obj_image_locations``; so are ``get_goal_pix``,
  ``valid_rollout``, ``goal_reached`` and the ``eval()`` stats.
- A fresh scene (no reset state) drawn after seeding the global ``random``
  and ``np.random`` alike is the same scene: the port mirrors every draw of
  the JAX env, call for call, and leaves the global streams in the same
  state.

Everything is exact: no tolerance."""

import os
import pickle
import random

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.goal_sources import (
    TrajectoryFolderGoalSource)
from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
    autograsp_env as t_ag, cartgripper_xz_grasp as t_xz)
from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
    autograsp_env as j_ag, cartgripper_xz_grasp as j_xz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = os.path.join(REPO, 'benchmarks', 'tasks')
# the env params of benchmarks/{xz_bench20,ag_bench20}/hparams.py
XZ_PARAMS = {'viewer_image_height': 96, 'viewer_image_width': 128,
             'cube_objects': True}
AG_PARAMS = {'num_objects': 3, 'viewer_image_height': 96,
             'viewer_image_width': 128, 'cube_objects': True, 'ncam': 1,
             'finger_sensors': True, 'object_object_mindist': 0.15,
             'skip_first': 6,
             'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0,
                           'reopen': True}}
ENVS = {'xz': (t_xz.CartgripperXZGrasp, j_xz.CartgripperXZGrasp, XZ_PARAMS,
               'xz_lifting_bench20'),
        'ag': (t_ag.AutograspCartgripperEnv, j_ag.AutograspCartgripperEnv,
               AG_PARAMS, 'ag_bench20')}
STEPS = 5
POINT_WIDTH = 64


def _task(task_set, itr):
    hp = {'start_goal_confs': os.path.join(TASKS, task_set),
          'image_height': 48, 'image_width': 64, 'data_save_dir': '/unused'}
    return TrajectoryFolderGoalSource(hp, ncam=1).load(itr)


def _actions(env):
    rng = np.random.RandomState(5)
    scale = np.full(env.adim, 0.08)
    if env.adim == 3:
        scale[1] = 0.05
    a = rng.uniform(-1, 1, (STEPS, env.adim)) * scale
    if env.adim == 3:       # the xz grasp bit: open, then closed
        a[:, 2] = np.where(np.arange(STEPS) < 2, -1.0, 1.0)
    return a


def assert_obs_equal(port, ref, where):
    assert sorted(port) == sorted(ref), where
    for key in ref:
        a, b = np.asarray(port[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, key)
        assert np.array_equal(a, b), (where, key)


@pytest.mark.parametrize('env_name,itr', [('xz', 0), ('xz', 1), ('ag', 0)])
def test_env_replays_a_vendored_task_as_jax_does(env_name, itr):
    port_cls, jax_cls, params, task_set = ENVS[env_name]
    spec = _task(task_set, itr)
    envs = [cls(params, spec.reset_state) for cls in (port_cls, jax_cls)]
    try:
        for env in envs:
            env.set_goal_obj_pose(spec.goal_obj_pose)
        (obs_p, reset_p), (obs_j, reset_j) = [env.reset() for env in envs]
        assert_obs_equal(obs_p, obs_j, 'reset')
        assert pickle.dumps(reset_p) == pickle.dumps(reset_j)
        assert obs_p['images'].shape == (1, 96, 128, 3)
        assert obs_p['images'].std() > 0       # a rendered scene, not blank
        for t, action in enumerate(_actions(envs[0])):
            obs_p, obs_j = [env.step(action.copy()) for env in envs]
            assert_obs_equal(obs_p, obs_j, 'step {}'.format(t))
        port, ref = envs
        assert np.array_equal(port.get_goal_pix(POINT_WIDTH),
                              ref.get_goal_pix(POINT_WIDTH))
        assert port.valid_rollout() == ref.valid_rollout()
        assert port.goal_reached() == ref.goal_reached()
        stats_p, stats_j = port.eval(POINT_WIDTH), ref.eval(POINT_WIDTH)
        assert sorted(stats_p) == ['final_dist', 'improvement',
                                   'initial_dist']
        for key in stats_j:
            assert stats_p[key] == stats_j[key], key
        assert port._save_buffer and all(
            np.array_equal(a, b) for a, b in zip(port._save_buffer,
                                                 ref._save_buffer))
    finally:
        for env in envs:
            env.close()


@pytest.mark.parametrize('env_name,seed', [('xz', 3), ('ag', 4)])
def test_fresh_scene_draws_as_jax_does(env_name, seed):
    port_cls, jax_cls, params, _ = ENVS[env_name]
    outs = []
    for cls in (port_cls, jax_cls):
        random.seed(seed)
        np.random.seed(seed)
        env = cls(params)
        try:
            obs, reset_state = env.reset()
            outs.append((obs, reset_state, np.random.rand(), random.random()))
        finally:
            env.close()
    (obs_p, reset_p, np_p, py_p), (obs_j, reset_j, np_j, py_j) = outs
    assert_obs_equal(obs_p, obs_j, 'fresh reset')
    assert pickle.dumps(reset_p) == pickle.dumps(reset_j)
    assert (np_p, py_p) == (np_j, py_j)     # the streams left alike


def test_smoke_task0_constants_are_the_envs():
    """``chip_smoke.py`` drives the dump on task 0 without MuJoCo: its start
    frame, pixels and state are the port env's at reset."""
    import cv2
    import chip_smoke
    spec = _task('xz_lifting_bench20', 0)
    env = t_xz.CartgripperXZGrasp(XZ_PARAMS, spec.reset_state)
    try:
        env.set_goal_obj_pose(spec.goal_obj_pose)
        obs, _ = env.reset()
        scale = POINT_WIDTH / obs['images'].shape[2]
        assert np.array_equal(
            np.round(obs['obj_image_locations'] * scale).astype(np.int64),
            chip_smoke.TASK0_DESIG_PIX)
        assert np.array_equal(env.get_goal_pix(POINT_WIDTH),
                              chip_smoke.TASK0_GOAL_PIX)
        assert np.array_equal(obs['state'], chip_smoke.TASK0_STATE)
        frame = cv2.resize(obs['images'][0], (64, 48),
                           interpolation=cv2.INTER_AREA)
        assert np.array_equal(frame, cv2.imread(chip_smoke.TASK0_FRAME)[
            :, :, ::-1])
    finally:
        env.close()


def test_env_utils_equal_jax():
    """The interpolation primitives (robot controllers'), the autograsp
    latch and the touch test give JAX's numbers."""
    from visual_foresight_torch.envs.mujoco_env.cartgripper_env.util import (
        sensor_util as t_sensor)
    from visual_foresight_torch.envs.util import action_util as t_action
    from visual_foresight_torch.envs.util import interpolation as t_interp
    from visual_foresight_tpu.envs.mujoco_env.cartgripper_env.util import (
        sensor_util as j_sensor)
    from visual_foresight_tpu.envs.util import action_util as j_action
    from visual_foresight_tpu.envs.util import interpolation as j_interp
    rng = np.random.RandomState(2)
    p1, p2 = rng.randn(2, 3), rng.randn(2, 3)
    t = np.linspace(0, 1.5, 7)
    for name, args in (('QuinticSpline', (p1, p2, 1.5)),
                       ('TwoPointCSpline', (p1[0], p2[0], 1.5)),
                       ('CSpline', (rng.randn(5, 3), 1.5))):
        port = getattr(t_interp, name)(*args)
        ref = getattr(j_interp, name)(*args)
        # CSpline takes one time at a time
        for x in ((0.7, 2.0) if name == 'CSpline' else (t, 0.7)):
            for a, b in zip(port.get(x), ref.get(x)):
                assert np.array_equal(a, b), name
    prev = rng.randn(5)
    for z, closed, reopen, grasp in ((-0.1, False, True, False),
                                     (0.1, True, True, False),
                                     (0.1, True, False, False),
                                     (0.1, True, True, True)):
        args = (prev, rng.randn(4), closed, z, -0.06, reopen, grasp)
        (qp, cl), (qj, cj) = (t_action.autograsp_dynamics(*args),
                              j_action.autograsp_dynamics(*args))
        assert np.array_equal(qp, qj) and cl == cj
    for sensors in ([0, 1], [1, 1], [0.5, 0]):
        assert t_sensor.is_touching(sensors) == j_sensor.is_touching(sensors)
