"""Port parity: ``BenchmarkAgent`` and its goal source,
``visual_foresight_torch``'s against the JAX package's.

- ``TrajectoryFolderGoalSource.load`` gives the same ``GoalSpec`` for a
  vendored task (``--iex`` too), and raises on a missing goal image.
- One benchmark episode of T=6 steps under a fixed-action policy, on
  ``xz_lifting_bench20`` task 0 (``CartgripperXZGrasp``) and ``ag_bench20``
  task 0 (``AutograspCartgripperEnv``, three objects), gives the same
  ``agent_data`` (goal image, pose and pixels, designated pixels in point
  space, reset state, ``stats``, ``term_t``, ``traj_ok``), the same
  observation history and policy outputs; the raw trajectory files the two
  packages' ``RawSaver`` write from them are equal byte for byte.
- With its file worker started, the port's agent hands the worker to the
  policy as ``verbose_worker`` and writes the final recording as a GIF
  (the port's own encoder) whose frames are the env's renders within the
  3-3-2 quantiser's error; ``cleanup`` drains and stops the worker.

Everything but the GIF is exact: no tolerance."""

import filecmp
import io
import os
import pickle

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent import benchmarking_agent as t_bench
from visual_foresight_torch.agent import goal_sources as t_goal
from visual_foresight_torch.agent.utils import raw_saver as t_raw
from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
    autograsp_env as t_ag, cartgripper_xz_grasp as t_xz)
from visual_foresight_torch.utils.gif import QUANT_ERROR
from visual_foresight_tpu.agent import benchmarking_agent as j_bench
from visual_foresight_tpu.agent import goal_sources as j_goal
from visual_foresight_tpu.agent.utils import raw_saver as j_raw
from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
    autograsp_env as j_ag, cartgripper_xz_grasp as j_xz)

from test_torch_envs import AG_PARAMS, TASKS, XZ_PARAMS

T = 6
PACKAGES = {'port': (t_bench.BenchmarkAgent, t_raw.RawSaver,
                     {'xz': t_xz.CartgripperXZGrasp,
                      'ag': t_ag.AutograspCartgripperEnv}),
            'jax': (j_bench.BenchmarkAgent, j_raw.RawSaver,
                    {'xz': j_xz.CartgripperXZGrasp,
                     'ag': j_ag.AutograspCartgripperEnv})}
CAMPAIGNS = {'xz': (XZ_PARAMS, 'xz_lifting_bench20', 3),
             'ag': (AG_PARAMS, 'ag_bench20', 4)}


class FixedPolicy:
    """Plays a given (T, adim) action sequence."""

    def __init__(self, actions):
        self.actions = actions

    def act(self, t):
        return {'actions': self.actions[t].copy()}

    def reset(self):
        pass


def _conf(pkg, campaign, root, **extra):
    params, task_set, _ = CAMPAIGNS[campaign]
    agent_cls, _, envs = PACKAGES[pkg]
    conf = {'type': agent_cls, 'env': (envs[campaign], dict(params)),
            'data_save_dir': str(root), 'T': T, 'image_height': 48,
            'image_width': 64,
            'start_goal_confs': os.path.join(TASKS, task_set),
            'current_dir': str(root)}
    conf.update(extra)
    return conf


def _fixed_actions(adim):
    return np.random.RandomState(8).uniform(-0.05, 0.05, (T, adim))


def _goal_hp(task_set, **extra):
    return dict({'start_goal_confs': os.path.join(TASKS, task_set),
                 'image_height': 48, 'image_width': 64,
                 'data_save_dir': '/unused'}, **extra)


@pytest.mark.parametrize('task_set,iex', [('xz_lifting_bench20', None),
                                          ('ag_bench20', None),
                                          ('ag_bench20', 3)])
def test_goal_source_loads_as_jax_does(task_set, iex):
    extra = {} if iex is None else {'iex': iex}
    port = t_goal.TrajectoryFolderGoalSource(_goal_hp(task_set, **extra),
                                             ncam=1).load(1)
    ref = j_goal.TrajectoryFolderGoalSource(_goal_hp(task_set, **extra),
                                            ncam=1).load(1)
    assert port._fields == ref._fields
    assert pickle.dumps(tuple(port)) == pickle.dumps(tuple(ref))
    assert port.goal_image.shape == (2, 1, 48, 64, 3)
    assert port.save_path.endswith('traj_{}'.format(1 if iex is None
                                                    else iex))


def test_goal_source_missing_image_raises():
    hp = dict(_goal_hp('ag_bench20'), start_goal_confs='/nonexistent')
    with pytest.raises(ValueError, match='goal image'):
        t_goal.TrajectoryFolderGoalSource(hp, ncam=1).load(0)


@pytest.mark.parametrize('campaign', sorted(CAMPAIGNS))
def test_benchmark_episode_equals_jax(campaign, tmp_path):
    adim = CAMPAIGNS[campaign][2]
    episodes = {}
    for pkg in PACKAGES:
        agent_cls, saver_cls, _ = PACKAGES[pkg]
        agent = agent_cls(_conf(pkg, campaign, tmp_path / pkg),
                          start_saver=False)
        try:
            agent_data, obs, policy_out = agent.sample(
                FixedPolicy(_fixed_actions(adim)), 0)
        finally:
            agent.env.close()
        episodes[pkg] = (agent_data, obs, policy_out)
        saver_cls(str(tmp_path / pkg), subdir='').save_traj(
            0, dict(agent_data), dict(obs), policy_out)

    (data_p, obs_p, out_p), (data_j, obs_j, out_j) = \
        episodes['port'], episodes['jax']
    assert sorted(data_p) == sorted(data_j)
    assert data_p['verbose_worker'] is None          # start_saver=False
    for key in data_j:
        assert pickle.dumps(data_p[key]) == pickle.dumps(data_j[key]), key
    assert sorted(data_p['stats']) == ['final_dist', 'improvement',
                                       'initial_dist']
    assert data_p['term_t'] == T - 1 and data_p['traj_ok']
    assert pickle.dumps(out_p) == pickle.dumps(out_j)
    # the raw trajectory: frames as PNG, the three pickles
    cmp = filecmp.dircmp(str(tmp_path / 'port' / 'traj_group0'),
                         str(tmp_path / 'jax' / 'traj_group0'))
    files = []

    def walk(d):
        assert not (d.left_only or d.right_only or d.diff_files or
                    d.funny_files), d.report()
        files.extend(d.same_files)
        for sub in d.subdirs.values():
            walk(sub)
    walk(cmp)
    assert sorted(files) == sorted(
        ['agent_data.pkl', 'obs_dict.pkl', 'policy_out.pkl'] +
        ['im_{}.png'.format(t) for t in range(T + 1)])
    for (path, _, names) in os.walk(str(tmp_path / 'port')):
        for name in names:                  # dircmp compares shallowly
            other = os.path.join(str(tmp_path / 'jax'), os.path.relpath(
                os.path.join(path, name), str(tmp_path / 'port')))
            if name.endswith(('.png', '.pkl')):
                assert filecmp.cmp(os.path.join(path, name), other,
                                   shallow=False), name


def test_file_worker_writes_the_recording(tmp_path):
    iio = pytest.importorskip('imageio.v3')
    conf = _conf('port', 'xz', tmp_path, make_final_recording=True)
    agent = t_bench.BenchmarkAgent(conf)
    worker = agent._save_worker
    try:
        agent_data, _, _ = agent.sample(FixedPolicy(_fixed_actions(3)), 0)
        assert agent_data['verbose_worker'] is worker
        frames = np.stack(agent.env._save_buffer)
    finally:
        agent.env.close()
        agent.cleanup()
    assert not worker._proc.is_alive()
    with open(os.path.join(str(tmp_path), 'record', 'traj_0.gif'),
              'rb') as f:
        data = f.read()
    assert data[:6] == b'GIF89a'
    got = np.asarray(iio.imread(io.BytesIO(data), index=None,
                                extension='.gif', mode='RGB'))
    assert got.shape == frames.shape == (T + 1, 96, 128, 3)
    err = np.abs(got.astype(int) - frames).max(axis=(0, 1, 2))
    assert (err <= QUANT_ERROR).all(), err


def test_policy_abi_equals_jax():
    """``get_policy_args`` fills a policy's ``act`` as JAX's does;
    ``NullPolicy`` acts with zeros and refuses an override equal to its
    default; ``DummyPolicy`` takes the runner's constructor."""
    from visual_foresight_torch import policy as t_policy
    from visual_foresight_tpu import policy as j_policy

    class Probe:
        def act(self, t, i_tr, state, obs, step_data, goal_pos,
                optional=42):
            return {}

    obs = {'state': np.arange(3)}
    step = {'goal_pos': np.ones(2), 'foo': 1}
    got = t_policy.get_policy_args(Probe(), obs, 5, 2, step)
    want = j_policy.get_policy_args(Probe(), obs, 5, 2, step)
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] or np.array_equal(got[k], want[k])
               for k in want)
    class NeedsGoal:
        def act(self, must_have):
            return {}

    with pytest.raises(ValueError, match='Required'):
        t_policy.get_policy_args(NeedsGoal(), {}, 0, 0, None)
    null = t_policy.NullPolicy({'adim': 4}, {})
    assert np.array_equal(null.act()['actions'], np.zeros(4))
    with pytest.raises(ValueError, match='identical'):
        t_policy.NullPolicy({'adim': 2}, {'wait_for_user': False})
    assert t_policy.DummyPolicy({}, {}, 0, 1).act() is None
