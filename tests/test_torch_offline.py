"""The port's offline replay and human-scored CEM on the CPU, against the JAX
package.

- ``OfflineEnv``: the same observations from the same raw folders, cycling
  through them episode by episode (oracle ``tests/test_misc_parity.py``).
- One replay episode of ``campaigns/offline_towel_classifier.py`` cut to a
  3-step episode, 16x24 frames, 16 samples, a 5-action plan (``repeat`` 1),
  2 CEM iterations and a small predictor (``tests/test_torch_controller.
  py``'s, perturbed) with a seeded classifier, through ``OfflineAgent`` and
  ``ClassifierController`` with ``FoldingCEMSampler`` beside the JAX
  package's: actions within atol 1e-5, scores within rtol 1e-4 with the same
  elites (``tests/test_torch_controller_variants.py``'s tolerances).  The
  same cut through ``sim/run.py``: the tail runs 2 x (1 + 5) times in each
  episode's replan, every episode is written as a raw folder, and without a
  card the runner refuses unless the policy says ``'device': 'cpu'``.
- ``HumanCEMController`` with a seeded script of scores in place of
  ``input()``, beside JAX's host loop: the same actions, elites, pages and
  GIFs, and the refit follows the script.
- ``make_transport_tasks.generate`` and ``select_benchmark_tasks`` beside
  JAX's on the same scenes; the retry skips scenes that fail the
  stability guard (``ValueError``) or are born bad
  (``Environment_Exception``).
"""

import builtins
import copy
import glob
import os
import pickle
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aux_models import seeded
from test_torch_controller import PREDICTOR, _perturbed
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_verbose import ListWorker
from visual_foresight_torch.agent import offline_agent as t_agent
from visual_foresight_torch.envs import offline_env as t_env
from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
    autograsp_env as t_ag_env)
from visual_foresight_torch.models import cdna as t_cdna
from visual_foresight_torch.models.convert import (load_flax_params,
                                                   params_from_flax)
from visual_foresight_torch.policy.cem_controllers import (
    human_cem_controller as t_human)
from visual_foresight_torch.policy.cem_controllers.samplers import (
    folding_sampler as t_fold)
from visual_foresight_torch.policy.cem_controllers.variants import (
    classifier_controller as t_clf)
from visual_foresight_torch.sim import run as t_run
from visual_foresight_torch.sim.util import (
    make_transport_tasks as t_tasks, select_benchmark_tasks as t_select)
from visual_foresight_tpu.agent import offline_agent as j_agent
from visual_foresight_tpu.envs import offline_env as j_env
from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
    autograsp_env as j_ag_env)
from visual_foresight_tpu.policy.cem_controllers import (
    human_cem_controller as j_human)
from visual_foresight_tpu.policy.cem_controllers.samplers import (
    folding_sampler as j_fold)
from visual_foresight_tpu.policy.cem_controllers.variants import (
    classifier_controller as j_clf)
from visual_foresight_tpu.sim.util import (
    make_transport_tasks as j_tasks, select_benchmark_tasks as j_select)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                    'offline_towel_classifier.py')
SEED = 5
ACTION_ATOL, SCORE_RTOL = 1e-5, 1e-4
H, W = 16, 24
# the towel twin cut to a 3-step episode at 16x24, 16 samples of a 5-action
# plan (repeat 1), 2 iterations, 10 elites
CUT_AGENT = {'T': 3, 'image_height': H, 'image_width': W}
CUT_POLICY = {'T': 5, 'repeat': 1, 'num_samples': 16, 'iterations': 2,
              'predictor_hparams': PREDICTOR, 'seed': SEED}


def write_replay(root, n=2, T=4, sdim=5, h=H, w=W):
    """``n`` raw trajectory folders of ``T`` frames (``images0/im_<t>.png``,
    ``obs_dict.pkl`` with a state of width ``sdim``)."""
    rng = np.random.RandomState(1)
    folders = []
    for i in range(n):
        traj = os.path.join(str(root), 'traj_group0', 'traj{}'.format(i))
        os.makedirs(os.path.join(traj, 'images0'))
        for t in range(T):
            cv2.imwrite(os.path.join(traj, 'images0', 'im_{}.png'.format(t)),
                        rng.randint(0, 255, (h, w, 3), np.uint8))
        with open(os.path.join(traj, 'obs_dict.pkl'), 'wb') as f:
            pickle.dump({'state': rng.rand(T, sdim),
                         'finger_sensors': rng.rand(T, 1)}, f)
        folders.append(traj)
    return folders


# -- the offline env -------------------------------------------------------------

def test_offline_env_replays_what_jax_replays(tmp_path):
    write_replay(tmp_path, n=2, T=3)
    envs = {side: module.OfflineSawyerEnv({'data_dir': str(tmp_path),
                                           'adim': 4, 'sdim': 5})
            for side, module in (('jax', j_env), ('port', t_env))}
    assert (envs['port'].adim, envs['port'].sdim, envs['port'].ncam) == \
        (envs['jax'].adim, envs['jax'].sdim, envs['jax'].ncam) == (4, 5, 1)
    for episode in range(3):           # the third is the first again
        obs = {s: [e.reset()[0]] + [e.step(np.zeros(4)) for _ in range(3)]
               for s, e in envs.items()}
        for t, (g, w) in enumerate(zip(obs['port'], obs['jax'])):
            assert sorted(g) == sorted(w) == ['finger_sensors', 'images',
                                              'state']
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
        assert obs['port'][0]['images'].shape == (1, H, W, 3)
        np.testing.assert_array_equal(obs['port'][3]['images'],
                                      obs['port'][2]['images'])  # clamped
    with pytest.raises(ValueError, match='no trajectories'):
        t_env.OfflineEnv({'data_dir': str(tmp_path / 'none')})


# -- one replay episode of the towel twin ------------------------------------------

def _towel_pair(replay, out):
    """The twin's agent and policy, cut, on both sides (the JAX side with
    the JAX package's classes), the port's weights converted from JAX's."""
    config = copy.deepcopy(t_run.load_config(TWIN))
    agent = dict(config['agent'], **CUT_AGENT, data_save_dir=str(out))
    agent['env'] = (agent['env'][0], dict(agent['env'][1],
                                          data_dir=str(replay)))
    policy = dict(config['policy'], **CUT_POLICY)
    del policy['model_path'], policy['classifier_path']
    classes = {t_agent.OfflineAgent: j_agent.OfflineAgent,
               t_env.OfflineSawyerEnv: j_env.OfflineSawyerEnv,
               t_clf.ClassifierController: j_clf.ClassifierController,
               t_fold.FoldingCEMSampler: j_fold.FoldingCEMSampler}
    jagent_hp = dict(agent, type=classes[agent['type']],
                     env=(classes[agent['env'][0]], dict(agent['env'][1])))
    jpolicy = dict(policy, type=classes[policy['type']],
                   sampler=classes[policy['sampler']])
    jagent = jagent_hp['type'](jagent_hp, start_saver=False)
    tagent = agent['type'](dict(agent), start_saver=False)
    with pytest.warns(UserWarning, match='seeded'):
        jctrl = jpolicy['type'](jagent._hyperparams, jpolicy)
        tctrl = policy['type'](tagent._hyperparams, dict(policy,
                                                         device='cpu'))
    jctrl.predictor.set_params([_perturbed(p, 9 + c) for c, p in
                                enumerate(jctrl.predictor.params)])
    tctrl.predictor.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                                for p in jctrl.predictor.params])
    tree = seeded(jctrl.classifier_params, 21)
    jctrl.classifier_params = jax.tree.map(jnp.asarray, tree)
    load_flax_params(tctrl.classifier, tree)
    return (jagent, jctrl), (tagent, tctrl)


def test_towel_replay_episode_matches_jax(tmp_path):
    write_replay(tmp_path / 'replay')
    (jagent, jctrl), (tagent, tctrl) = _towel_pair(tmp_path / 'replay',
                                                   tmp_path / 'out')
    assert tctrl._fused is None and jctrl._fused is None   # the host loop
    np.random.seed(SEED)              # JAX's host draws; the port's are its own
    want = jagent.sample(jctrl, 0)
    got = tagent.sample(tctrl, 0)
    assert got[0]['offline_replay'] is True and got[0]['traj_ok']
    assert sorted(got[1]) == sorted(want[1])
    for key in ('images', 'state'):
        np.testing.assert_array_equal(got[1][key], want[1][key])
    assert len(got[2]) == len(want[2]) == CUT_AGENT['T']
    for t, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g['actions'], w['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
        assert sorted(g['plan_stat']) == sorted(w['plan_stat'])
        for key, value in w['plan_stat'].items():
            np.testing.assert_allclose(g['plan_stat'][key], value,
                                       rtol=SCORE_RTOL, err_msg=key)
    np.testing.assert_array_equal(tctrl._best_indices, jctrl._best_indices)
    assert 'scores_itr1' in got[2][-1]['plan_stat']     # one replan, at t=1


CUT = '''import copy
from visual_foresight_torch.sim.run import load_config
config = copy.deepcopy(load_config({twin!r}))
config['agent'].update(data_save_dir={out!r}, **{agent!r})
config['agent']['env'][1]['data_dir'] = {replay!r}
config['policy'].update(model_path={out!r} + '/no_weights',
                        classifier_path={out!r} + '/no_classifier',
                        **{policy!r})
config['end_index'] = 2
config['current_dir'] = {out!r}
'''


def _cut_twin(root, **policy):
    path = os.path.join(str(root), 'cut.py')
    with open(path, 'w') as f:
        f.write(CUT.format(twin=TWIN, out=str(root / 'out'),
                           replay=str(root / 'replay'), agent=CUT_AGENT,
                           policy=dict(CUT_POLICY, **policy)))
    return path


def test_towel_twin_runs_and_writes_raw_trajectories(tmp_path, monkeypatch):
    write_replay(tmp_path / 'replay')
    calls = []
    tail = t_cdna.fused_warp_composite

    def counted_tail(*args, **kwargs):
        calls.append(1)
        return tail(*args, **kwargs)

    monkeypatch.setattr(t_cdna, 'fused_warp_composite', counted_tail)
    with pytest.warns(UserWarning, match='seeded'):
        result = t_run.main([_cut_twin(tmp_path, device='cpu')])
    assert result == str(tmp_path / 'out' / 'verbose')
    # 3 episodes (the replay cycles through its 2 folders), one replan each
    # of 2 iterations x one forward of 1 context + 5 plan steps
    assert len(calls) == 3 * CUT_POLICY['iterations'] * (1 + 5)
    trajs = sorted(glob.glob(str(tmp_path / 'out' / 'train' / 'traj_group0' /
                                 'traj*')))
    assert [os.path.basename(t) for t in trajs] == ['traj0', 'traj1',
                                                    'traj2']
    for traj in trajs:
        assert len(os.listdir(os.path.join(traj, 'images0'))) == \
            CUT_AGENT['T'] + 1
        with open(os.path.join(traj, 'policy_out.pkl'), 'rb') as f:
            actions = np.stack([p['actions'] for p in pickle.load(f)])
        assert actions.shape == (CUT_AGENT['T'], 4) and \
            np.isfinite(actions).all()
        with open(os.path.join(traj, 'agent_data.pkl'), 'rb') as f:
            assert pickle.load(f)['offline_replay'] is True


def test_towel_twin_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    write_replay(tmp_path / 'replay')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        t_run.main([_cut_twin(tmp_path)])
    assert not os.path.exists(tmp_path / 'out')    # nothing was built


# -- the human-scored CEM -------------------------------------------------------------

HUMAN_AGENT = {'adim': 3, 'sdim': 3, 'ncam': 1, 'image_height': H,
               'image_width': W, 'T': 6}
# 7 elites over the 6 plan dims (2 actions x 3): a refit of full rank
HUMAN_POLICY = {'T': 6, 'nactions': 2, 'num_samples': 12,
                'minimum_selection': 7, 'iterations': 2,
                'action_order': ['x', 'z', 'grasp'], 'initial_std_lift': 0.1,
                'rejection_sampling': False, 'predictor_hparams': PREDICTOR,
                'seed': SEED}


class ScriptedScores:
    """Answers ``input()``: no restored trajectory, then a seeded score
    for every sample the controller shows."""

    def __init__(self, seed, n):
        self.rng, self.n, self.given = np.random.RandomState(seed), n, []

    def __call__(self, prompt=''):
        if prompt.startswith('restore traj'):
            return 'n'
        assert prompt == 'Score for traj {}: '.format(
            len(self.given) % self.n), prompt
        self.given.append(float(self.rng.randint(0, 1000)) / 10)
        return str(self.given[-1])


def test_human_cem_follows_the_scores_as_jax_does(monkeypatch):
    jctrl = j_human.HumanCEMController(HUMAN_AGENT, dict(HUMAN_POLICY))
    jctrl.predictor.set_params([_perturbed(p, 9 + c) for c, p in
                                enumerate(jctrl.predictor.params)])
    tctrl = t_human.HumanCEMController(HUMAN_AGENT, dict(HUMAN_POLICY,
                                                         device='cpu'))
    tctrl.predictor.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                                for p in jctrl.predictor.params])
    assert tctrl._fused is None and jctrl._fused is None
    rng = np.random.RandomState(3)
    images = (rng.rand(3, 1, H, W, 3) * 255).astype(np.uint8)
    states = rng.randn(3, 3) * 0.05
    refits = []
    sample_next = t_human.HumanCEMController._make_sampler

    def traced_sampler(ctrl):
        sampler = sample_next(ctrl)
        refit = sampler.sample_next_actions

        def next_actions(n, best_actions, scores):
            out = refit(n, best_actions, scores)
            refits.append((best_actions.copy(), scores.copy(),
                           sampler._mean.copy()))
            return out
        sampler.sample_next_actions = next_actions
        return sampler

    monkeypatch.setattr(t_human.HumanCEMController, '_make_sampler',
                        traced_sampler)
    out, scripts, workers = {}, {}, {}
    np.random.seed(SEED)
    for side, ctrl in (('jax', jctrl), ('port', tctrl)):
        scripts[side] = ScriptedScores(11, HUMAN_POLICY['num_samples'])
        workers[side] = ListWorker()
        monkeypatch.setattr(builtins, 'input', scripts[side])
        ctrl.reset()
        out[side] = [ctrl.act(t=t, i_tr=0, images=images[:t + 1],
                              state=states[:t + 1],
                              verbose_worker=workers[side])
                     for t in range(2)]
    for t in range(2):
        np.testing.assert_allclose(out['port'][t]['actions'],
                                   out['jax'][t]['actions'],
                                   atol=ACTION_ATOL)
    np.testing.assert_array_equal(tctrl._best_indices, jctrl._best_indices)
    given = np.reshape(scripts['port'].given, (2, -1))
    assert scripts['port'].given == scripts['jax'].given
    for itr in range(2):
        np.testing.assert_array_equal(
            out['port'][1]['plan_stat']['scores_itr{}'.format(itr)],
            given[itr])
    # the elites are the lowest scores, and the refit mean is theirs
    (elites, elite_scores, mean), = refits
    k = tctrl.elite_count
    np.testing.assert_array_equal(elite_scores, np.sort(given[0])[:k])
    np.testing.assert_array_equal(
        mean, elites.reshape(k, 2, 3, 3)[:, :, -1].reshape(k, -1).mean(0))
    np.testing.assert_array_equal(tctrl._best_indices,
                                  np.argsort(given[1], kind='stable')[:k])
    np.testing.assert_array_equal(out['port'][1]['actions'],
                                  tctrl._best_actions[0, 0])
    # the pages and GIFs: the same items, frames within one level
    items = {s: w.items for s, w in workers.items()}
    assert [i[:2] for i in items['port']] == [i[:2] for i in items['jax']]
    for g, w in zip(items['port'], items['jax']):
        if g[0] == 'txt_file':
            assert g[2] == w[2]
        elif g[0] == 'mov':
            np.testing.assert_allclose(np.asarray(g[2], np.int16),
                                       np.asarray(w[2], np.int16), atol=1)
    assert sum(i[0] == 'mov' for i in items['port']) == \
        2 * HUMAN_POLICY['num_samples']


# -- task generation ------------------------------------------------------------------

TASK_ENV = {'num_objects': 2, 'viewer_image_height': 48,
            'viewer_image_width': 64, 'cube_objects': True, 'ncam': 1,
            'autograsp': {'zthresh': -0.06, 'touchthresh': 0.0,
                          'reopen': True}}


def _generate(env_module, tasks_module, bad_scene):
    """``tests/test_data_tools.py``'s loop, retrying on both of the errors
    a scene can raise: (attempts, generate's result)."""
    np.random.seed(2)
    random.seed(2)
    env = env_module.AutograspCartgripperEnv(copy.deepcopy(TASK_ENV))
    rng = np.random.RandomState(0)
    try:
        for attempt in range(1, 6):
            try:
                _, reset_state = env.reset()
                return attempt, tasks_module.generate(
                    env, reset_state, 0.2, rng, settle_steps=500)
            except (ValueError, bad_scene):
                continue
        raise AssertionError('no stable scene in 5 resets')
    finally:
        env.close()


def test_make_transport_tasks_generates_what_jax_generates(tmp_path):
    from visual_foresight_torch.agent.general_agent import (
        Environment_Exception as TBad)
    from visual_foresight_tpu.agent.general_agent import (
        Environment_Exception as JBad)
    j_attempts, want = _generate(j_ag_env, j_tasks, JBad)
    t_attempts, got = _generate(t_ag_env, t_tasks, TBad)
    assert t_attempts == j_attempts
    rs, fs, fg, qpos2, dist = got
    np.testing.assert_array_equal(qpos2, want[3])
    assert dist == want[4] and dist >= 0.15
    for a, b in zip(fs + fg, want[1] + want[2]):
        np.testing.assert_array_equal(a, b)
    assert qpos2.shape == (2, 2, 7)
    for side, module, result in (('jax', j_tasks, want),
                                 ('port', t_tasks, got)):
        module._write_task(str(tmp_path / side), *result[:4])
    for name in ('images0/im_0.png', 'images0/im_1.png', 'obs_dict.pkl'):
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes(), name


def test_select_benchmark_tasks_selects_what_jax_selects(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(4):
        traj = tmp_path / 'raw' / 'traj_group0' / 'traj{}'.format(i)
        os.makedirs(traj / 'images0')
        for t in range(3):
            cv2.imwrite(str(traj / 'images0' / 'im_{}.png'.format(t)),
                        rng.randint(0, 255, (8, 10, 3), np.uint8))
        qpos = rng.rand(3, 2, 7)
        with open(traj / 'obs_dict.pkl', 'wb') as f:
            pickle.dump({'object_qpos': qpos}, f)
        agent_data = {} if i == 3 else {'reset_state': {
            'qpos_all': np.arange(4 + 14, dtype=np.float64),
            'reset_xml': ['obj_a', 'obj_b']}}
        with open(traj / 'agent_data.pkl', 'wb') as f:
            pickle.dump(agent_data, f)
    chosen = {}
    for side, module in (('jax', j_select), ('port', t_select)):
        chosen[side] = [os.path.basename(p) for p in module.select_tasks(
            str(tmp_path / 'raw'), str(tmp_path / side), ntasks=2)]
    assert chosen['port'] == chosen['jax'] and len(chosen['port']) == 2
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / 'port')
                   for d, _, fs in os.walk(tmp_path / 'port') for f in fs)
    assert len(files) == 2 * 4
    for name in files:
        got, want = tmp_path / 'port' / name, tmp_path / 'jax' / name
        if name.endswith('.pkl'):
            with open(got, 'rb') as a, open(want, 'rb') as b:
                x, y = pickle.load(a), pickle.load(b)
            assert repr(x) == repr(y), name
        else:
            assert got.read_bytes() == want.read_bytes(), name


# -- CreateConfigAgent ----------------------------------------------------------------

def _config_task(agent_module, env_cls, seed):
    """One ``CreateConfigAgent`` rollout from ``seed``: (agent_data, obs)."""
    np.random.seed(seed)
    random.seed(seed)
    agent = agent_module.CreateConfigAgent(
        {'env': (env_cls, {'cube_objects': True, 'viewer_image_height': 48,
                           'viewer_image_width': 64}),
         'T': 1, 'image_height': 48, 'image_width': 64}, start_saver=False)
    try:
        agent_data, obs, _ = agent.rollout(None, 1, 0)
        return agent_data, obs
    finally:
        agent.env.close()


class _Deadline:
    """Fails the test instead of hanging: ``_move_objects`` retries until a
    grasp holds, which on some seeds takes minutes."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        import signal

        def expire(*_):
            raise AssertionError('no task within {} s'.format(self.seconds))
        self.saved = signal.signal(signal.SIGALRM, expire)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        import signal
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.saved)


def test_create_config_agent_matches_jax():
    """Seed 0 is a quick seed on the xz env (a grasp holds at the first
    tries: about 0.5 s on either side; seeds 2-5 and 7 ran past 8 s)."""
    from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
        cartgripper_xz_grasp as t_xz)
    from visual_foresight_torch.sim.util import config_agent as t_config
    from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
        cartgripper_xz_grasp as j_xz)
    from visual_foresight_tpu.sim.util import config_agent as j_config
    with _Deadline(120):
        want = _config_task(j_config, j_xz.CartgripperXZGrasp, 0)
        got = _config_task(t_config, t_xz.CartgripperXZGrasp, 0)
    assert got[0]['traj_ok'] and sorted(got[0]) == sorted(want[0])
    assert repr(got[0]['reset_state']) == repr(want[0]['reset_state'])
    assert sorted(got[1]) == sorted(want[1])
    for key, value in want[1].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[1][key], value, err_msg=key)
    assert got[1]['images'].shape[:3] == (2, 1, 48)   # start and goal
    # the goal snapshot moved the objects
    assert not np.array_equal(got[1]['object_qpos'][0],
                              got[1]['object_qpos'][1])


def test_create_config_agent_on_the_rot_env_fails_as_in_jax():
    """``CartgripperRotGraspEnv.generate_task`` raises in both packages
    (its ``_move_arm`` builds a 5-dim command, which numpy cannot broadcast
    against a 3-dim array)."""
    from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
        cartgripper_rot_grasp as t_rot)
    from visual_foresight_torch.sim.util import config_agent as t_config
    from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
        cartgripper_rot_grasp as j_rot)
    from visual_foresight_tpu.sim.util import config_agent as j_config
    errors = []
    for module, cls in ((j_config, j_rot.CartgripperRotGraspEnv),
                        (t_config, t_rot.CartgripperRotGraspEnv)):
        with pytest.raises(ValueError, match='broadcast') as info:
            _config_task(module, cls, 0)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
