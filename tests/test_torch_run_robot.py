"""The port's ``sim/run_robot.py`` against the JAX package's, on the CPU.

- ``RobotEnvironment`` of both packages on twins of the sawyer pixel-cost
  experiment (``campaigns/robot_sawyer_pixel_cost.py`` and its source
  ``experiments/sawyer/pixel_cost/hparams.py``) cut to 24 samples of a
  2-action plan (repeat 2), T 4, ``replan_interval`` 2, 16x24 frames for
  the agent: two cameras (the port's node in ``--test-pattern`` mode, its
  frames replaced by the same seeded frames on both sides), a kinematic fake
  arm (``chip_smoke.FakeArm``), scripted clicks and prompts
  (``chip_smoke.ScriptedClicks``, ``ScriptedPrompts``), the same weights
  (the JAX controller's, perturbed, carried over by the converter) and the
  JAX controller's draws injected (``test_torch_controller.
  tie_controllers``).  Two trajectories, then a third under ``resume``:
  the actions and states within atol 1e-5 (the tolerance of the offline
  and human CEM), equal stats, ``checkpoint.pkl`` and raw folders.
- The CLI: ``override_<robot>`` blocks, ``RESULT_DIR``, ``--benchmark``
  with a scripted name and ``-r`` give both packages' runners the same
  configuration.
- ``chip_smoke.py``'s phase 10 on the CPU at the same cut: the raw folders,
  the stats by hand and each camera's clip an mp4 read back.
"""

import os
import pickle
import time
from unittest import mock

import numpy as np
import pytest

import chip_smoke
from test_torch_controller import PREDICTOR, tie_controllers
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent import benchmarking_agent as t_bench
from visual_foresight_torch.envs.robot_envs import (
    autograsp_env as t_ag, base_env as t_base)
from visual_foresight_torch.envs.robot_envs.util import (
    camera_recorder as t_rec, topic_utils as t_topic)
from visual_foresight_torch.policy.cem_controllers import (
    pixel_cost_controller as t_pcc)
from visual_foresight_torch.sim import run_robot as t_robot
from visual_foresight_tpu.agent import benchmarking_agent as j_bench
from visual_foresight_tpu.envs.robot_envs import (
    autograsp_env as j_ag, base_env as j_base)
from visual_foresight_tpu.envs.robot_envs.util import (
    camera_recorder as j_rec, topic_utils as j_topic)
from visual_foresight_tpu.policy.cem_controllers import (
    pixel_cost_controller as j_pcc)
from visual_foresight_tpu.sim import run_robot as j_robot

ACTION_ATOL = 1e-5
FRAME = (48, 64)                   # the cameras' frames here
AGENT = {'T': 4, 'image_height': 16, 'image_width': 24}
POLICY = {'num_samples': 24, 'nactions': 2, 'repeat': 2, 'T': 4,
          'replan_interval': 2, 'verbose': False,
          'predictor_hparams': PREDICTOR}
ENV_SEED = 4
SIDES = {
    'port': {'run': t_robot, 'base': t_base, 'rec': t_rec, 'topic': t_topic,
             'agent': t_bench.BenchmarkAgent, 'env': t_ag.AutograspEnv,
             'policy': t_pcc.PixelCostController},
    'jax': {'run': j_robot, 'base': j_base, 'rec': j_rec, 'topic': j_topic,
            'agent': j_bench.BenchmarkAgent, 'env': j_ag.AutograspEnv,
            'policy': j_pcc.PixelCostController},
}


class QuickArm(chip_smoke.FakeArm):
    move_s = 0.0


def channels():
    return tuple('camera{}_image_raw_{}'.format(i, os.getpid())
                 for i in range(2))


@pytest.fixture(scope='module')
def cameras():
    with chip_smoke.CameraNodes(channels(), *FRAME, fps=60):
        yield


def topics(side):
    IMTopic = SIDES[side]['topic'].IMTopic
    return [IMTopic('/' + ch.replace('_image_raw', '/image_raw'),
                    height=FRAME[0], width=FRAME[1], flip=(i == 0))
            for i, ch in enumerate(channels())]


def twin(side, root, end_index, arm=QuickArm, save_video=False):
    """The twin cut to ``AGENT`` and ``POLICY`` with ``side``'s classes,
    results under ``root``."""
    config = chip_smoke.robot_config(
        os.path.join(str(root), 'no_weights'), str(root), end_index,
        save_video=save_video, env={'camera_topics': topics(side)},
        agent=AGENT, policy=dict(POLICY, **({'device': 'cpu'}
                                            if side == 'port' else {})))
    classes = SIDES[side]
    config['agent']['type'] = classes['agent']
    config['agent']['env'] = (classes['env'],
                              dict(config['agent']['env'][1],
                                   robot_type=arm))
    config['policy']['type'] = classes['policy']
    return config


def frame_feed(seed=6, n=7):
    """``CameraRecorder.get_image`` giving each camera seeded frames in
    turn, stamped now."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (2, n) + FRAME + (3,)).astype(np.uint8)
    counts = {}

    def get_image(recorder):
        name = recorder._topic_data.name
        cam = int(name.split('/')[1][len('camera'):])
        k = counts[name] = counts.get(name, -1) + 1
        return time.time(), frames[cam, k % n].copy()
    return get_image


def build(config, resume=False):
    """Both packages' ``RobotEnvironment`` on their twins of ``config``
    (a function of the side), the port's controller tied to JAX's."""
    with pytest.warns(UserWarning, match='seeded'):
        robots = {side: SIDES[side]['run'].RobotEnvironment(
            config(side), resume=resume, benchmark=True) for side in SIDES}
    tie_controllers(robots['jax'].policy, robots['port'].policy,
                    dict(POLICY))
    return robots


def run(side, robot, trajs):
    """Run ``robot`` with scripted clicks and prompts and seeded frames;
    returns (clicks, prompts, the raw pickles of trajectories ``trajs`` by
    index).  Read before the file worker stops: the JAX package pickles the
    worker's queue proxy into ``agent_data.pkl``, which loads only while
    the worker's manager runs."""
    classes = SIDES[side]
    clicks = chip_smoke.ScriptedClicks(chip_smoke.ROBOT_CLICK_SEED)
    prompts = chip_smoke.ScriptedPrompts()
    np.random.seed(ENV_SEED)
    with mock.patch.object(classes['base'], 'select_points', clicks), \
            mock.patch('builtins.input', prompts), \
            mock.patch.object(classes['rec'].CameraRecorder, 'get_image',
                              frame_feed()):
        robot.run()
    root = robot.agentparams['data_save_dir']
    raw = {}
    for i in trajs:
        folder = os.path.join(root, 'raw', 'traj_group0', 'traj{}'.format(i))
        raw[i] = {name: pickle.load(open(os.path.join(folder, name + '.pkl'),
                                         'rb'))
                  for name in ('agent_data', 'obs_dict', 'policy_out')}
        raw[i]['jpgs'] = sorted(os.listdir(os.path.join(folder, 'images1')))
    raw['trajs'] = sorted(os.listdir(os.path.join(root, 'raw',
                                                  'traj_group0')))
    robot.agent.cleanup()
    robot.agent.env.close()
    return clicks, prompts, raw


def checkpoint(root):
    with open(os.path.join(str(root), 'checkpoint.pkl'), 'rb') as f:
        return pickle.load(f)['ntraj']


def compare(got, want, trajs):
    assert got['trajs'] == want['trajs']
    for i in trajs:
        g, w = got[i], want[i]
        assert g['jpgs'] == w['jpgs'] == ['im_{}.jpg'.format(t) for t in
                                          sorted(range(AGENT['T'] + 1),
                                                 key=str)]
        for key in ('state', 'qpos'):
            np.testing.assert_allclose(g['obs_dict'][key],
                                       w['obs_dict'][key], atol=ACTION_ATOL,
                                       err_msg='traj {} {}'.format(i, key))
        assert len(g['policy_out']) == len(w['policy_out']) == AGENT['T']
        for t, (pg, pw) in enumerate(zip(g['policy_out'], w['policy_out'])):
            np.testing.assert_allclose(pg['actions'], pw['actions'],
                                       atol=ACTION_ATOL,
                                       err_msg='traj {} t={}'.format(i, t))
        sg, sw = g['agent_data']['stats'], w['agent_data']['stats']
        assert sorted(sg) == sorted(sw)
        for key in sw:
            assert float(sg[key]) == float(sw[key]), key
        assert sorted(g['agent_data']) == sorted(
            k for k in w['agent_data'] if k != 'verbose_worker')
        for key in ('desig_pix', 'goal_pix', 'term_t', 'traj_ok'):
            np.testing.assert_array_equal(g['agent_data'][key],
                                          w['agent_data'][key])


def test_run_robot_matches_jax(cameras, tmp_path):
    robots = build(lambda side: twin(side, tmp_path / side, 1))
    out = {side: run(side, robots[side], (0, 1)) for side in ('jax', 'port')}
    compare(out['port'][2], out['jax'][2], (0, 1))
    assert out['port'][1].seen == out['jax'][1].seen
    assert checkpoint(tmp_path / 'port') == checkpoint(tmp_path / 'jax') == 2

    # -r with end_index 2: the third trajectory alone
    robots = build(lambda side: twin(side, tmp_path / side, 2), resume=True)
    out = {side: run(side, robots[side], (2,)) for side in ('jax', 'port')}
    compare(out['port'][2], out['jax'][2], (2,))
    assert out['port'][2]['trajs'] == ['traj0', 'traj1', 'traj2']
    assert len(out['port'][0].calls) == len(out['jax'][0].calls) == 2
    assert checkpoint(tmp_path / 'port') == checkpoint(tmp_path / 'jax') == 3


EXPERIMENT = '''import copy
from visual_foresight_torch.sim.run import load_config
config = copy.deepcopy(load_config({twin!r}))
config['agent']['data_save_dir'] = {root!r}
config['override_vestri'] = {{'agent': {{'T': 7}},
                              'policy': {{'num_samples': 12}}}}
config['override_sudri'] = {{'agent': {{'T': 9}}}}
'''


@pytest.mark.parametrize('flags,result_dir', [
    ([], False), (['--benchmark', '-r'], True), (['--benchmark'], False)],
    ids=['plain', 'benchmark_resume_result_dir', 'benchmark'])
def test_cli_surfaces_match_jax(tmp_path, flags, result_dir):
    path = tmp_path / 'exp.py'
    path.write_text(EXPERIMENT.format(twin=chip_smoke.ROBOT_TWIN,
                                      root=str(tmp_path / 'data')))
    env = {'RESULT_DIR': str(tmp_path / 'result')} if result_dir else {}
    seen = {}
    for side in SIDES:
        module = SIDES[side]['run']
        calls = []
        with mock.patch.dict(os.environ, env), \
                mock.patch.object(module, 'RobotEnvironment',
                                  lambda c, **kw: calls.append((c, kw)) or
                                  mock.Mock()), \
                mock.patch('builtins.input', lambda prompt: ' run7 '):
            module.main([str(path), 'vestri'] + flags)
        (config, kw), = calls
        assert os.path.isdir(config['agent']['data_save_dir'])
        seen[side] = (config['agent']['data_save_dir'],
                      config['agent']['env'][1]['robot_name'],
                      config['agent']['T'], config['policy']['num_samples'],
                      sorted(k for k in config if k.startswith('override')),
                      kw)
    assert seen['port'] == seen['jax']
    root = str(tmp_path / ('result' if result_dir else 'data'))
    want = os.path.join(root, 'bench_run7') if flags else root
    assert seen['port'][:5] == (want, 'vestri', 7, 12, ['override_sudri'])
    assert seen['port'][5] == {'resume': '-r' in flags,
                               'benchmark': '--benchmark' in flags}


def test_chip_smoke_robot_phase_on_the_cpu(cameras, tmp_path):
    """Phase 10's helpers at the cut: the run, the raw folders, the stats
    by hand, each camera's clip an mp4 of T or more frames (the fake arm's
    moves take ``FakeArm.move_s``: the cameras record meanwhile), and the
    resumed third trajectory."""
    log = chip_smoke.ReplanClock(lambda: None)
    config = twin('port', tmp_path, 1, arm=chip_smoke.FakeArm,
                  save_video=True)
    with pytest.warns(UserWarning, match='seeded'):
        clicks, prompts, ctrl = chip_smoke.run_robot_twin(config, log)
    assert ctrl.device.type == 'cpu' and ctrl.predictor.n_cam == 2
    assert len(log.ms) == 4 and len(log.acts) == 2
    assert [p for p in prompts.seen if 'definition' in p] == \
        ['Is definition okay? (y/n): '] * 2
    frames = chip_smoke.check_robot_trajs(
        str(tmp_path), (0, 1), clicks, AGENT['T'], True,
        width=AGENT['image_width'], raw_width=FRAME[1])
    assert len(frames) == 4 and min(frames) >= AGENT['T']
    assert checkpoint(tmp_path) == 2
    with pytest.warns(UserWarning, match='seeded'):
        clicks, _, _ = chip_smoke.run_robot_twin(
            twin('port', tmp_path, 2, arm=chip_smoke.FakeArm,
                 save_video=True), chip_smoke.ReplanClock(lambda: None),
            resume=True)
    chip_smoke.check_robot_trajs(str(tmp_path), (2,), clicks, AGENT['T'],
                                 True, width=AGENT['image_width'],
                                 raw_width=FRAME[1])
    assert checkpoint(tmp_path) == 3
    # the stats are held to the clicks: one moved click fails the check
    clicks.calls[-1][1][0, 0, 1] += 20
    with pytest.raises(AssertionError, match='by hand'):
        chip_smoke.check_robot_trajs(str(tmp_path), (2,), clicks,
                                     AGENT['T'], False,
                                     width=AGENT['image_width'],
                                     raw_width=FRAME[1])


@pytest.mark.parametrize('run_fails', [True, False],
                         ids=['run_fails', 'run_ends'])
def test_chip_smoke_twin_run_keeps_its_own_error(run_fails):
    """``chip_smoke.run_robot_twin`` closes the cameras and the file worker
    either way; the worker's ``Mp4Unwritable`` is raised only where the run
    itself went through, and a failed run raises its own error."""
    from visual_foresight_torch.agent.utils.file_saver import Mp4Unwritable
    closed = []

    class Env(object):
        def close(self):
            closed.append('cameras')

    class Agent(object):
        env = Env()

        def cleanup(self):
            closed.append('worker')
            raise Mp4Unwritable('cv2.VideoWriter cannot open clip.mp4')

    class Robot(object):
        def __init__(self, config, resume=False, benchmark=False):
            self.agent, self.policy = Agent(), None

        def run(self):
            if run_fails:
                raise ValueError('the run failed')

    with mock.patch.object(t_robot, 'RobotEnvironment', Robot), \
            pytest.raises(ValueError if run_fails else Mp4Unwritable):
        chip_smoke.run_robot_twin({}, chip_smoke.ReplanClock(lambda: None))
    assert closed == ['cameras', 'worker']


# phase 10's RoboNet and collection drives at a small size on the CPU: the
# franka twin (host-loop MPPI, one camera) through run_robot --benchmark,
# and the sawyer grasp collection twin (five cameras) without it
ROBONET_CUT = {'agent': {'T': 7, 'image_height': 16, 'image_width': 24},
               'policy': {'device': 'cpu', 'num_samples': 12,
                          'iterations': 2, 'verbose': False,
                          'model_path': 'no_weights',
                          'predictor_hparams': PREDICTOR}}
COLLECT_CUT = {'agent': {'T': 4, 'image_height': 24, 'image_width': 32},
               'policy': {'nactions': 4}}


@pytest.mark.parametrize('drive', ['robonet_franka', 'collect_sawyer_grasp'])
def test_chip_smoke_robot_twin_drives_on_the_cpu(drive, monkeypatch):
    """``chip_smoke.drive_robonet_robot``: one replan a trajectory at t=5
    in the host loop, two trajectories, the raw folders and the stats by
    hand; ``chip_smoke.drive_robot_collection``: one GaussianPolicy
    trajectory, every camera's frames read back, no tail launch."""
    monkeypatch.setattr(chip_smoke.FakeArm, 'move_s', 0.0)
    if drive == 'robonet_franka':
        with pytest.warns(UserWarning, match='seeded'):
            paths = chip_smoke.drive_robonet_robot('cpu', False, ROBONET_CUT)
        assert paths == {'robot_robonet_franka': {}}
    else:
        paths = chip_smoke.drive_robot_collection('cpu', COLLECT_CUT)
        assert paths['robot_collect_sawyer_grasp'] == {
            'cdna_tail': 0, 'cdna_tail_eff': 0, 'cdna_tail_dna': 0}


# phase 12's twins built on the CPU: every robot twin as a user builds it, at
# tiny predictor widths without weights; the groups of equal points and each
# group's predicted tail launches a replan
TWINS_CUT = {'device': 'cpu', 'model_path': 'no_weights',
             'predictor_hparams': PREDICTOR}
GROUP_LAUNCHES = {
    ('robot_sawyer_human_cem',): 96,
    ('robot_sawyer_registration_experiments',): 92,
    ('robot_sawyer_towel_classifier',): 48,
    ('robot_sawyer_mixed_objects_deformable',): 92,
    ('robot_sawyer_mixed_objects_hardobjects',): 92,
    ('robonet_baxter_fine_tune', 'robonet_baxter_fine_tune_baxter_scratch',
     'robonet_baxter_fine_tune_sawyer_baxter_fine_tune',
     'robonet_view_generalization_single_view'): 55,
    ('robonet_franka',): 55,
    ('robonet_new_bin_inlay_all_robots', 'robonet_new_bin_inlay_sawyer_only',
     'robonet_robotiq_fine_tune_start_all',
     'robonet_robotiq_fine_tune_start_sawyer',
     'robonet_robotiq_from_scratch', 'robonet_robotiq_zero_shot',
     'robonet_view_generalization_all_views'): 55,
    ('robonet_pixel_cost',): 42,
    ('robonet_inverse_model_franka_inverse_conf',): 0,
    ('robonet_inverse_model_multibot_one_step',
     'robonet_inverse_model_sawyer_one_step'): 0,
    ('robonet_inverse_model_sawyer_two_step',): 0,
}


def test_chip_smoke_robot_twins_built_on_the_cpu():
    """``chip_smoke.robot_twin_groups``: each of the 22 twins raises as its
    source does as written, then builds; 12 groups; each group's first
    controller built on the CPU plans the predicted launches a replan
    (``robot_launches``: the registration twin's at 96x128, two cameras)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        groups = chip_smoke.robot_twin_groups(TWINS_CUT, {'device': 'cpu'})
    assert {tuple(m[0] for m in g) for g in groups} == set(GROUP_LAUNCHES)
    assert sum(len(g) for g in groups) == 22
    for members in groups:
        name, cost, cls, agent, policy = members[0]
        want = GROUP_LAUNCHES[tuple(m[0] for m in members)]
        if cost == 'inverse':
            # the stand-in net, at 192x256
            ctrl = cls(agent, dict(policy))
            assert ctrl.predictor.restored and want == 0
            assert (agent['image_height'], agent['image_width']) == (192, 256)
            continue
        with pytest.warns(UserWarning, match='seeded'):
            ctrl = cls(agent, dict(policy))
        assert ctrl.device.type == 'cpu'
        got = chip_smoke.robot_launches(cost, agent['ncam'], ctrl)
        assert got == want, name
        if cost == 'registration':
            assert (agent['image_height'], agent['image_width'],
                    agent['ncam'], ctrl._n_desig) == (96, 128, 2, 2)
