"""The port's robot envs against the JAX package's, on the CPU, with the
kinematic fake arm of ``tests/test_robot_env.py`` and the port's native
camera node in ``--test-pattern`` mode (its frames replaced by the same
seeded frames on both sides).

- ``VanillaEnv`` and ``AutograspEnv`` of both packages under the same seeded
  actions: observations, states, ``_previous_target_qpos``, the gripper and
  autograsp flags bit for bit, through ``normalize_actions`` and the
  workspace clip; the interactive goal and ``eval()`` from the same
  scripted clicks give the same stats; ``IMTopic.process_image`` (crop,
  flip, ``INTER_AREA`` resize) bit for bit on the same frame.
- The JAX file's own two cases, on the port.
- The file worker writes a movie named ``.mp4`` as an mp4 (an ``ftyp`` box,
  its frames read back by OpenCV), keeps GIF89a for ``.gif`` and reports
  a writer that does not open when it is closed.
"""

import os
import time
from unittest import mock

import numpy as np
import pytest

import chip_smoke
from test_robot_env import FakeController
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.envs.robot_envs import (
    autograsp_env as t_ag, base_env as t_base, vanilla_env as t_van)
from visual_foresight_torch.envs.robot_envs.util import (
    camera_recorder as t_rec, topic_utils as t_topic)
from visual_foresight_tpu.envs.robot_envs import (
    autograsp_env as j_ag, base_env as j_base, vanilla_env as j_van)
from visual_foresight_tpu.envs.robot_envs.util import (
    camera_recorder as j_rec, topic_utils as j_topic)

H, W = 48, 64
SIDES = {'jax': (j_van.VanillaEnv, j_ag.AutograspEnv, j_base, j_rec, j_topic),
         'port': (t_van.VanillaEnv, t_ag.AutograspEnv, t_base, t_rec,
                  t_topic)}


def channels():
    return ['torch_env{}_{}'.format(i, os.getpid()) for i in range(2)]


@pytest.fixture(scope='module')
def cameras():
    with chip_smoke.CameraNodes(channels(), H, W, fps=60):
        yield


def env_params(side, **over):
    IMTopic = SIDES[side][4].IMTopic
    params = {'robot_name': 'example_robot', 'robot_type': FakeController,
              'gripper_attached': 'none', 'cleanup_rate': -1,
              'camera_topics': [IMTopic(channels()[0], height=24, width=32,
                                        flip=True),
                                IMTopic(channels()[1], height=24, width=32,
                                        top=4, left=6)]}
    params.update(over)
    return params


def frame_feed(seed=2, n=5):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (2, n, 24, 32, 3)).astype(np.uint8)
    counts = {}

    def get_image(recorder):
        name = recorder._topic_data.name
        cam = channels().index(name)
        k = counts[name] = counts.get(name, -1) + 1
        return time.time(), frames[cam, k % n].copy()
    return get_image


def episode(side, autograsp, actions, **over):
    """Reset, an interactive goal, the actions, then ``eval()``: the
    observations and the env's state after each step, and the stats."""
    van, ag, base, rec, _ = SIDES[side]
    clicks = chip_smoke.ScriptedClicks(7)
    np.random.seed(11)
    with mock.patch.object(rec.CameraRecorder, 'get_image', frame_feed()), \
            mock.patch.object(base, 'select_points', clicks), \
            mock.patch('builtins.input', chip_smoke.ScriptedPrompts()):
        env = (ag if autograsp else van)(env_params(side, **over))
        goal = env.get_obj_desig_goal(None)
        obs = [env.reset()[0]]
        trace = []
        for a in actions:
            obs.append(env.step(a.copy()))
            trace.append((env._previous_target_qpos.copy(),
                          getattr(env, '_gripper_closed', None),
                          getattr(env, '_prev_touch', None),
                          env._controller._gripper))
        stats = env.eval(target_width=16, ntasks=1)
    env.close()
    return obs, trace, stats, goal


@pytest.mark.parametrize('autograsp,over', [
    (False, {}), (False, {'normalize_actions': True, 'start_at_neutral': True}),
    (True, {'zthresh': 0.6}), (True, {'zthresh': 0.3, 'reopen': False,
                                      'normalize_actions': True})],
    ids=['vanilla', 'vanilla_normalized', 'autograsp', 'autograsp_latched'])
def test_robot_env_matches_jax(cameras, autograsp, over):
    rng = np.random.RandomState(5)
    adim = 4 if autograsp else 5
    actions = rng.uniform(-0.3, 0.3, (6, adim))
    actions[:3, 2] = -0.4                      # down, past zthresh
    want = episode('jax', autograsp, actions, **over)
    got = episode('port', autograsp, actions, **over)
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg='t={} {}'.format(t, key))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
    assert got[2] == want[2] and set(got[2]) == {'final_dist', 'start_dist',
                                                 'improvement'}
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    if autograsp:
        assert any(t[1] for t in got[1])       # the latch closed once


@pytest.mark.parametrize('kw', [
    {}, {'flip': True}, {'height': 20, 'width': 30, 'top': 3, 'bot': 5,
                         'left': 2, 'right': 7, 'flip': True},
    {'height': 48, 'width': 64, 'top': 8}], ids=['same', 'flip', 'crop_resize',
                                                 'crop_upscale'])
def test_im_topic_matches_jax(kw):
    frame = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    topics = [m.IMTopic('x', **dict({'height': 40, 'width': 56}, **kw))
              for m in (j_topic, t_topic)]
    got, want = (t.process_image(frame) for t in topics[::-1])
    np.testing.assert_array_equal(got, want)
    assert got.shape[:2] == (topics[1].height, topics[1].width)


# -- the JAX file's own cases, on the port ---------------------------------------

def test_vanilla_robot_env_step(cameras):
    env = t_van.VanillaEnv(env_params('port', start_at_neutral=True,
                                      save_video=False))
    assert env.adim == 5 and env.sdim == 5 and env.ncam == 2
    obs, reset_state = env.reset()
    assert obs['images'].shape == (2, 24, 32, 3) and reset_state is None
    assert obs['state'].shape == (5,)
    assert np.all(obs['state'][:3] >= -0.01) and \
        np.all(obs['state'][:3] <= 1.01)
    prev_state = obs['state'].copy()
    obs2 = env.step(np.array([0.05, 0.02, -0.01, 0.1, -1.0]))
    assert not np.allclose(obs2['state'][:3], prev_state[:3])
    assert env.valid_rollout()
    env.close()


def test_autograsp_robot_env(cameras):
    env = t_ag.AutograspEnv(env_params('port', start_at_neutral=True,
                                       zthresh=0.6))
    assert env.adim == 4
    env.reset()
    for _ in range(4):
        env.step(np.array([0.0, 0.0, -0.2, 0.0]))
    assert env._gripper_closed
    env.close()


@pytest.mark.parametrize('autograsp', [False, True],
                         ids=['vanilla', 'autograsp'])
def test_env_class_states_its_widths_and_topics(cameras, autograsp):
    """The widths and default cameras a planner reads from the env class
    before any robot connects: those of the built env, and the JAX
    package's default topics."""
    cls = (t_ag.AutograspEnv if autograsp else t_van.VanillaEnv)
    env = cls(env_params('port', start_at_neutral=True))
    assert (env.adim, env.sdim) == (cls.ACTION_DIM, cls.STATE_DIM) == \
        ((4, 5) if autograsp else (5, 5))
    env.close()
    want = j_base.BaseRobotEnv._default_hparams(
        object.__new__(j_base.BaseRobotEnv)).camera_topics
    got = cls.DEFAULT_CAMERA_TOPICS
    assert [(t.name, t.flip, t.height, t.width) for t in got] == \
        [(t.name, t.flip, t.height, t.width) for t in want]
    assert t_base.BaseRobotEnv.ACTION_DIM is None
    with pytest.raises(ValueError, match='BaseRobotEnv states no action'):
        chip_smoke.robot_twin_agent(
            {'agent': {'env': (t_base.BaseRobotEnv, {})}})


# -- the file worker's movies ------------------------------------------------------

def test_file_worker_writes_mp4_for_mp4_names(tmp_path):
    import cv2
    from visual_foresight_torch.agent.utils.file_saver import (
        start_file_worker)
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
              for _ in range(5)]
    worker = start_file_worker()
    worker.put(('path', str(tmp_path)))
    worker.put(('mov', 'recording0/front_clip.mp4', frames, 30))
    worker.put(('mov', 'anim.gif', frames, 4))
    worker.close()
    with open(str(tmp_path / 'recording0' / 'front_clip.mp4'), 'rb') as f:
        head = f.read(12)
    assert head[4:8] == b'ftyp', head
    with open(str(tmp_path / 'anim.gif'), 'rb') as f:
        assert f.read(6) == b'GIF89a'
    capture, read = cv2.VideoCapture(
        str(tmp_path / 'recording0' / 'front_clip.mp4')), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        read.append(frame)
    capture.release()
    assert len(read) == 5 and read[0].shape == (48, 64, 3)
    # RGB in, as the GIFs take it: the red channel of the first frame
    # comes back as OpenCV's last (lossy codec: compare the means)
    assert abs(float(read[0][..., 2].mean()) -
               float(frames[0][..., 0].mean())) < 10


def test_file_worker_reports_an_mp4_it_cannot_open(tmp_path):
    from visual_foresight_torch.agent.utils.file_saver import (
        Mp4Unwritable, start_file_worker)
    (tmp_path / 'clip.mp4').mkdir()            # a directory in the way
    worker = start_file_worker()
    worker.put(('path', str(tmp_path)))
    worker.put(('mov', 'clip.mp4', [np.zeros((8, 8, 3), np.uint8)], 30))
    with pytest.raises(Mp4Unwritable, match='VideoWriter'):
        worker.close()
    # any other failure of the worker is a plain RuntimeError
    worker = start_file_worker()
    worker.put(('path', str(tmp_path)))
    worker.put(('txt_file', 'clip.mp4', 'a file over a directory'))
    with pytest.raises(RuntimeError) as info:
        worker.close()
    assert type(info.value) is RuntimeError
