"""The port's data collection on the CPU, against the JAX package.

- Each random and scripted collection policy (``policy/random/*``,
  ``policy/handcrafted/*``, ``policy/interactive/*``): the same actions bit
  for bit under one ``np.random.seed``; the transport demonstrator on the
  ideal plant of ``tests/test_grasp_transport_policy.py``.
- The pusher and xyz cartgripper envs: reset and step observations (the
  rendered frames too) bit for bit from one ``np.random.seed``.
- ``HDF5Saver`` and ``file_2_hdf5``: the same datasets, values and attrs.
- ``file_2_record``: the same record streams (decompressed: ``gzip`` stamps
  the time into each file's header) and manifests on the same raw folders,
  read back through both packages' readers.
- ``sim/run.py`` on ``campaigns/collect_xz_r4.py`` cut to T 6 (2 actions
  under ``repeat`` 3) and two trajectories in one worker, beside the JAX
  runner on the config it twins, cut the same way: the same records (every
  worker seeds the global streams with None; here that seed is fixed on both
  sides).  The same config in two ``spawn`` workers: two trajectories
  recorded and read back.  ``utils/summarize_dataset.py`` on the records.
- The runner's output layouts (``RESULT_DIR``, ``EXPERIMENT_DIR``,
  ``--cloud``, the default) and the ``master_datadir`` sync thread, each
  against the JAX runner's.
"""

import copy
import datetime
import gzip
import json
import os
import pickle
import random
import time
import types

import cv2
import h5py
import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.utils import hdf5_saver as t_hdf5
from visual_foresight_torch.data import dataset_reader as t_reader
from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
    cartgripper_pusher as t_pusher, cartgripper_xyz as t_xyz)
from visual_foresight_torch.policy.handcrafted import (
    grasp_transport_policy as t_transport, lifting_policy as t_lifting,
    playback_policy as t_playback)
from visual_foresight_torch.policy.interactive import (
    classifier_collector as t_collector)
from visual_foresight_torch.policy.random import (
    gaussian as t_gauss, random_fold_policy as t_fold,
    sampler_policy as t_sampler)
from visual_foresight_torch.sim import run as t_run
from visual_foresight_torch.sim.util import synchronize_tfrecs as t_sync
from visual_foresight_torch.utils import file_2_hdf5 as t_f2h
from visual_foresight_torch.utils import file_2_record as t_f2r
from visual_foresight_torch.utils import summarize_dataset as t_summary
from visual_foresight_tpu.agent.utils import hdf5_saver as j_hdf5
from visual_foresight_tpu.data import dataset_reader as j_reader
from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
    cartgripper_pusher as j_pusher, cartgripper_xyz as j_xyz)
from visual_foresight_tpu.policy.handcrafted import (
    grasp_transport_policy as j_transport, lifting_policy as j_lifting,
    playback_policy as j_playback)
from visual_foresight_tpu.policy.interactive import (
    classifier_collector as j_collector)
from visual_foresight_tpu.policy.random import (
    gaussian as j_gauss, random_fold_policy as j_fold,
    sampler_policy as j_sampler)
from visual_foresight_tpu.sim import run as j_run
from visual_foresight_tpu.sim.util import synchronize_tfrecs as j_sync
from visual_foresight_tpu.utils import file_2_hdf5 as j_f2h
from visual_foresight_tpu.utils import file_2_record as j_f2r

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                    'collect_xz_r4.py')
SOURCE = os.path.join(REPO, 'data_collection', 'sim', 'cartgripper_xz_grasp',
                      'r4_flagship', 'hparams.py')
ENV_PARAMS = {'viewer_image_height': 96, 'viewer_image_width': 128,
              'cube_objects': True}


# -- the collection policies ----------------------------------------------------

def _states(t, sdim, seed=11):
    return np.random.RandomState(seed).rand(t + 1, sdim)


def _drive(policy, kind, T):
    """``T`` act() calls with the inputs that ``kind`` takes; the actions."""
    actions = []
    for t in range(T):
        if kind == 'plain':
            out = policy.act(t)
        elif kind == 'state':
            out = policy.act(t=t, state=_states(t, 5))
        elif kind == 'sensors':
            state = _states(t, 5)
            state[:, -1] = np.linspace(-1, 1, t + 1)
            out = policy.act(t, state, np.abs(_states(t, 2, seed=t)))
        elif kind == 'poses':
            poses = np.random.RandomState(4).rand(1, 3, 7)
            out = policy.act(t, _states(t, 3), poses)
        actions.append(np.array(out['actions'], copy=True))
    return np.stack(actions)


# name -> (JAX class, port class, agent params, policy params, act inputs)
POLICIES = {
    'gaussian': (j_gauss.GaussianPolicy, t_gauss.GaussianPolicy,
                 {'adim': 3, 'T': 12}, {'nactions': 4, 'action_order':
                                        ['x', 'z', 'grasp']}, 'plain'),
    'gaussian_discrete_gripper': (
        j_gauss.GaussianPolicy, t_gauss.GaussianPolicy, {'adim': 4, 'T': 6},
        {'nactions': 2, 'discrete_gripper': 3, 'action_bound': False},
        'plain'),
    'gaussian_ag_epsilon': (
        j_gauss.GaussianAGEpsilonPolicy, t_gauss.GaussianAGEpsilonPolicy,
        {'adim': 5, 'T': 9}, {'p_epsilon': 0.5, 'nactions': 3}, 'sensors'),
    'random_fold': (j_fold.RandomFoldPolicy, t_fold.RandomFoldPolicy,
                    {'adim': 4, 'T': 30}, {'action_bound': True}, 'state'),
    'sampler_correlated_noise': (
        j_sampler.SamplerPolicy, t_sampler.SamplerPolicy,
        {'adim': 4, 'T': 8}, {'beta_0': 0.3}, 'plain'),
    'lifting': (j_lifting.LiftingPolicy, t_lifting.LiftingPolicy,
                {'adim': 3, 'T': 16}, {'nactions': 8, 'repeat': 2},
                'poses'),
    'classifier_collector': (
        j_collector.CollectExamplesPolicy, t_collector.CollectExamplesPolicy,
        {'adim': 5, 'T': 5}, {'gripper_prob': 0.3}, 'state'),
}


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_collection_policy_draws_what_jax_draws(name):
    jcls, tcls, ag_params, policy, kind = POLICIES[name]
    got = {}
    for side, cls in (('jax', jcls), ('port', tcls)):
        np.random.seed(SEED)
        got[side] = _drive(cls(dict(ag_params), dict(policy)), kind,
                           ag_params['T'])
    assert got['port'].shape == (ag_params['T'], ag_params['adim'])
    np.testing.assert_array_equal(got['port'], got['jax'])
    if name == 'gaussian_discrete_gripper':
        assert set(np.unique(got['port'][:, 3])) <= {-1.0, 1.0}


def test_discretize_gripper_matches_jax():
    actions = np.random.RandomState(0).randn(5, 4)
    np.testing.assert_array_equal(
        t_gauss.discretize_gripper(actions.copy(), 2),
        j_gauss.discretize_gripper(actions.copy(), 2))


def test_playback_policy_replays_the_pickle(tmp_path):
    recorded = [{'actions': np.random.RandomState(t).randn(3)}
                for t in range(4)]
    path = tmp_path / 'act.pkl'
    with open(path, 'wb') as f:
        pickle.dump(recorded, f)
    for cls in (j_playback.PlaybackPolicy, t_playback.PlaybackPolicy):
        policy = cls({'adim': 3}, {'file': str(path)})
        got = [policy.act(state=None, t=t)['actions'] for t in range(4)]
        np.testing.assert_array_equal(got, [r['actions'] for r in recorded])


def _transport_rollout(cls, seed, p_rand, graspable=True):
    """``tests/test_grasp_transport_policy.py``'s ideal plant, for either
    package's demonstrator: (actions, phases, final object poses)."""
    rng = np.random.RandomState(seed)
    np.random.seed(seed)
    policy = cls({'adim': 4, 'T': 30}, {} if p_rand == 0.1 else
                 {'p_rand': p_rand})              # 0.1 is the default
    low = np.array([-0.5, -0.5, -0.08, -2 * np.pi])
    high = np.array([0.5, 0.5, 0.15, 2 * np.pi])
    pos = np.array([0.3, -0.25, 0.13, 0.0])
    obj = np.concatenate([rng.uniform(-0.2, 0.2, 2), [-0.08],
                          [1.0, 0, 0, 0]])
    objs = np.stack([obj, obj + np.array([.25, .25, 0, 0, 0, 0, 0]),
                     obj + np.array([-.25, .2, 0, 0, 0, 0, 0])])
    grasped = False
    states, obj_hist, actions, phases = [], [], [], []
    for t in range(30):
        states.append(np.concatenate([pos, [1.0]]))
        obj_hist.append(objs.copy())
        a = policy.act(t, np.stack(states), np.stack(obj_hist))['actions']
        actions.append(a)
        phases.append(policy._phase)
        pos = pos + a
        pos[:3] = np.clip(pos[:3], low[:3], high[:3])
        if graspable and not grasped and pos[2] < -0.05 and \
                np.linalg.norm(pos[:2] - objs[0, :2]) < 0.05:
            grasped = True
        if grasped:
            objs[0, :2] = pos[:2]
            objs[0, 2] = max(pos[2] - 0.02, -0.08)
    return np.asarray(actions), phases, objs


@pytest.mark.parametrize('seed,p_rand,graspable', [(0, 0.1, True),
                                                   (2, 0.3, False)])
def test_grasp_transport_matches_jax(seed, p_rand, graspable):
    want = _transport_rollout(j_transport.GraspTransportPolicy, seed, p_rand,
                              graspable)
    got = _transport_rollout(t_transport.GraspTransportPolicy, seed, p_rand,
                             graspable)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    if graspable:
        assert 'carry' in got[1] and 'place' in got[1]


# -- the pusher and xyz envs ------------------------------------------------------

ENVS = {'pusher': (j_pusher.CartgripperPusherEnv,
                   t_pusher.CartgripperPusherEnv,
                   np.array([0.05, -0.02, 0.0, 0.1]), 4),
        'xyz': (j_xyz.CartgripperXYZEnv, t_xyz.CartgripperXYZEnv,
                np.array([0.03, 0.0, -0.02]), 3)}


def _episode(cls, action):
    np.random.seed(1)
    random.seed(1)
    env = cls(dict(ENV_PARAMS))
    try:
        obs = [env.reset()[0]]
        for _ in range(2):
            obs.append(env.step(action))
        return obs, (env.adim, env.sdim)
    finally:
        env.close()


@pytest.mark.parametrize('name', sorted(ENVS))
def test_env_observations_equal_jax(name):
    jcls, tcls, action, dim = ENVS[name]
    want, jdims = _episode(jcls, action)
    got, tdims = _episode(tcls, action)
    assert tdims == jdims == (dim, dim)
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), t
        for key in w:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg='{} t={}'.format(key, t))
    assert got[-1]['state'].shape == (dim,)
    assert got[0]['images'].shape == (1, 96, 128, 3)


# -- HDF5 ------------------------------------------------------------------------

def _h5_tree(path):
    """Every dataset's value and every attr, by path, of one HDF5 file."""
    tree = {}

    def visit(name, obj):
        tree[name + '@attrs'] = {k: np.asarray(v).tolist()
                                 for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            tree[name] = np.asarray(obj[()])

    with h5py.File(path, 'r') as f:
        tree['/@attrs'] = {k: np.asarray(v).tolist()
                           for k, v in f.attrs.items()}
        f.visititems(visit)
    return tree


def _assert_same_h5(got, want):
    a, b = _h5_tree(got), _h5_tree(want)
    assert sorted(a) == sorted(b)
    for key, value in b.items():
        if key.endswith('@attrs'):
            assert a[key] == value, key
        else:
            assert a[key].dtype == value.dtype, key
            np.testing.assert_array_equal(a[key], value, err_msg=key)


def _h5_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(('.h5', '.hdf5')))


def test_hdf5_saver_writes_what_jax_writes(tmp_path):
    rng = np.random.RandomState(0)
    trajs = []
    for n in (4, 6, 5):                  # two padded, one full
        trajs.append(({'images': rng.randint(0, 255, (n + 1, 1, 8, 10, 3),
                                             np.uint8),
                       'state': rng.randn(n + 1, 3)},
                      [{'actions': rng.randn(3)} for _ in range(n)]))
    for side, module in (('jax', j_hdf5), ('port', t_hdf5)):
        np.random.seed(SEED)
        saver = module.HDF5Saver(str(tmp_path / side), {}, {'T': 6},
                                 traj_per_file=1, split=(0.5, 0.25, 0.25))
        for i, (obs, policy_out) in enumerate(trajs):
            saver.save_traj(i, {}, dict(obs), policy_out)
    files = _h5_files(tmp_path / 'port')
    assert files == _h5_files(tmp_path / 'jax') and len(files) == 3
    for f in files:
        _assert_same_h5(tmp_path / 'port' / f, tmp_path / 'jax' / f)
    np.testing.assert_array_equal(t_hdf5.get_pad_mask(4, 6),
                                  j_hdf5.get_pad_mask(4, 6))


def _write_raw(root, idx, T=4, ncam=1, h=16, w=20, ext='jpg', sdim=3,
              adim=3):
    """One raw trajectory folder of the layout ``RawSaver`` writes."""
    rng = np.random.RandomState(7 + idx)
    traj = os.path.join(str(root), 'traj_group0', 'traj{}'.format(idx))
    for n in range(ncam):
        os.makedirs(os.path.join(traj, 'images{}'.format(n)))
        for t in range(T):
            cv2.imwrite('{}/images{}/im_{}.{}'.format(traj, n, t, ext),
                        rng.randint(0, 255, (h, w, 3), np.uint8))
    state = rng.randn(T + 1, sdim)
    state[:, -1] = rng.choice([-1.0, 1.0], T + 1)
    data = {'agent_data': {'term_t': T - 1, 'traj_ok': True,
                           'stats': {'x': 1}},
            'obs_dict': {'state': state,
                         'finger_sensors': rng.rand(T + 1, 1)},
            'policy_out': [{'actions': rng.randn(adim)} for _ in range(T)]}
    for name, value in data.items():
        with open('{}/{}.pkl'.format(traj, name), 'wb') as f:
            pickle.dump(value, f)
    return traj


def test_file_2_hdf5_writes_what_jax_writes(tmp_path):
    from visual_foresight_tpu.utils.file_2_hdf5 import MANDATORY_KEYS
    assert t_f2h.MANDATORY_KEYS == MANDATORY_KEYS
    for i in range(2):
        _write_raw(tmp_path / 'raw', i, T=3, ncam=2, ext='png')
    meta = dict({k: 'test' for k in MANDATORY_KEYS}, primitives=['a', 'b'])
    (tmp_path / 'meta.json').write_text(json.dumps(meta))
    for side, module in (('jax', j_f2h), ('port', t_f2h)):
        random.seed(SEED)
        module.main([str(tmp_path / side), str(tmp_path / 'raw'),
                     '--metadata', str(tmp_path / 'meta.json')])
    files = _h5_files(tmp_path / 'port')
    assert files == _h5_files(tmp_path / 'jax') == ['traj0.hdf5',
                                                     'traj1.hdf5']
    for f in files:
        _assert_same_h5(tmp_path / 'port' / f, tmp_path / 'jax' / f)
    tree = _h5_tree(tmp_path / 'port' / files[0])
    assert tree['env@attrs']['n_cams'] == 2
    frame = cv2.imdecode(tree['env/cam1_video/frame2'], cv2.IMREAD_COLOR)
    assert frame.shape == (16, 20, 3)


# -- raw folders to records ---------------------------------------------------------

def _record_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_records(got, want):
    """The same files; each shard's decompressed stream and each manifest
    byte for byte."""
    files = _record_files(got)
    assert files == _record_files(want) and files
    for f in files:
        opener = gzip.open if f.endswith('.tfrecords') else open
        with opener(os.path.join(got, f), 'rb') as a, \
                opener(os.path.join(want, f), 'rb') as b:
            assert a.read() == b.read(), f
    return files


def _read_back(root, mode, keys):
    """Every trajectory of ``mode`` through both readers, which must
    agree; the port's batches."""
    batches = {}
    for side, reader in (('jax', j_reader), ('port', t_reader)):
        ds = reader.BaseVideoDataset(root, 1, hparams_dict={
            'shuffle': False, 'num_epochs': 1})
        batches[side] = list(ds.numpy_iterator(keys=keys, mode=mode))
        ds.close()
    assert len(batches['port']) == len(batches['jax']) > 0
    for g, w in zip(batches['port'], batches['jax']):
        for key in keys:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    return batches['port']


@pytest.mark.parametrize('flags', [[], ['--infer_gripper', '--seperate']],
                         ids=['plain', 'infer_gripper_seperate'])
def test_file_2_record_writes_what_jax_writes(tmp_path, flags):
    for i in range(3):
        # --infer_gripper appends a fifth action dim to four
        _write_raw(tmp_path / 'raw', i, adim=4 if flags else 3)
    for side, module in (('jax', j_f2r), ('port', t_f2r)):
        random.seed(SEED)
        np.random.seed(SEED)
        module.main([str(tmp_path / side), str(tmp_path / 'raw'), '10',
                     '--T', '4', '--nworkers', '1', '--traj_per_file', '2',
                     '--split', '0.5', '0.5', '0.0'] + flags)
    files = _assert_same_records(str(tmp_path / 'port'),
                                 str(tmp_path / 'jax'))
    root = str(tmp_path / 'port' / ('good' if flags else ''))
    if flags and not any(f.startswith('good/train') for f in files):
        root = str(tmp_path / 'port' / 'bad')
    mode = 'train' if any('train' in f for f in files) else 'val'
    back = _read_back(root, mode, ('images', 'actions', 'state'))
    assert back[0]['images'].shape == (1, 4, 1, 8, 10, 3)   # 20 -> 10 wide
    assert back[0]['actions'].shape[-1] == (5 if flags else 3)


# -- the collection run ---------------------------------------------------------------

CUT = '''import copy
from {package}.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
# cut to T 6 (2 actions under repeat 3) and two trajectories
config['agent'].update(T=6, data_save_dir={out!r})
config['policy'].update(nactions=2)
config.update(start_index=0, end_index=1, traj_per_file=2,
              current_dir={root!r})
{extra}
'''


def _cut(root, package, src, extra=''):
    os.makedirs(str(root), exist_ok=True)
    path = os.path.join(str(root), 'cut.py')
    with open(path, 'w') as f:
        f.write(CUT.format(package=package, src=src, root=str(root),
                           out=os.path.join(str(root), 'data'),
                           extra=extra))
    return path


@pytest.fixture
def fixed_worker_seeds(monkeypatch):
    """The runners' workers seed the global streams with None; here with
    ``SEED``, on both sides."""
    for module, name in ((np.random, 'seed'), (random, 'seed')):
        seed = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda s=None, _seed=seed: _seed(
                                SEED if s is None else s))


def _poll(check, timeout=30.0):
    end = time.time() + timeout
    while not check():
        if time.time() > end:
            return False
        time.sleep(0.05)
    return True


def test_collection_run_records_what_jax_records(tmp_path,
                                                 fixed_worker_seeds):
    sync = "config['agent']['master_datadir'] = {!r}"
    for side, package, src, run in (
            ('jax', 'visual_foresight_tpu', SOURCE, j_run),
            ('port', 'visual_foresight_torch', TWIN, t_run)):
        config = _cut(tmp_path / side, package, src,
                      sync.format(str(tmp_path / side / 'master')))
        np.random.seed(SEED)
        random.seed(SEED)
        assert run.main([config]) == str(tmp_path / side / 'verbose')
    records = {s: str(tmp_path / s / 'data' / 'records')
               for s in ('jax', 'port')}
    files = _assert_same_records(records['port'], records['jax'])
    assert sum(f.endswith('.tfrecords') for f in files) >= 1
    keys = ('images', 'actions', 'state')
    n = 0
    for half in ('good', 'bad'):
        for mode in ('train', 'val', 'test'):
            if os.listdir(os.path.join(records['port'], half, mode)):
                back = _read_back(os.path.join(records['port'], half), mode,
                                  keys)
                n += len(back)
                assert back[0]['images'].shape == (1, 6, 1, 48, 64, 3)
                assert back[0]['actions'].shape == (1, 6, 3)
    assert n == 2
    # the sync thread's last copy is on disk when the port's runner returns;
    # the JAX runner leaves it to its daemon thread
    assert _record_files(str(tmp_path / 'port' / 'master')) == \
        _record_files(str(tmp_path / 'port' / 'data'))
    assert _poll(lambda: _record_files(str(tmp_path / 'jax' / 'master')) ==
                 _record_files(str(tmp_path / 'jax' / 'data')))

    # the dataset summary: one GIF a trajectory of 6 frames of 48x64
    import imageio
    out = tmp_path / 'summary'
    bad = os.path.join(records['port'], 'bad')
    mode = next(m for m in ('train', 'val', 'test')
                if os.listdir(os.path.join(bad, m)))
    t_summary.main([bad, '--n', '1', '--mode', mode, '--out_dir', str(out)])
    frames = imageio.mimread(str(out / 'traj0_cam0.gif'))
    assert len(frames) == 6 and frames[0].shape[:2] == (48, 64)


def test_collection_run_in_two_spawned_workers(tmp_path, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '2')   # the spawned workers' torch
    config = _cut(tmp_path, 'visual_foresight_torch', TWIN)
    t_run.main([config, '--nworkers', '2'])
    root = str(tmp_path / 'data' / 'records')
    n = 0
    for half in ('good', 'bad'):
        for mode in ('train', 'val', 'test'):
            if os.listdir(os.path.join(root, half, mode)):
                back = _read_back(os.path.join(root, half), mode,
                                  ('images', 'actions'))
                n += len(back)
    assert n == 2


# -- the output layouts and the sync thread ----------------------------------------

def _layout_config(root):
    return {'current_dir': str(root / 'experiments' / 'lift' / 'r1'),
            'save_raw_images': True,
            'agent': {'data_save_dir': str(root / 'experiments' / 'lift' /
                                           'data'),
                      'make_final_gif': True, 'T': 6},
            'policy': {'verbose': True}}


@pytest.mark.parametrize('layout', ['RESULT_DIR', 'EXPERIMENT_DIR', 'cloud',
                                    'default'])
@pytest.mark.parametrize('benchmark', [False, True],
                         ids=['collect', 'benchmark'])
def test_result_dir_layouts_equal_jax(tmp_path, monkeypatch, layout,
                                      benchmark):
    hparams = tmp_path / 'hparams.py'
    hparams.write_text('config = {}\n')
    frozen = types.SimpleNamespace(datetime=types.SimpleNamespace(
        now=lambda: datetime.datetime(2026, 1, 2, 3, 4)))
    got = {}
    for side, run in (('jax', j_run), ('port', t_run)):
        root = tmp_path / side
        monkeypatch.setattr(run, 'datetime', frozen)
        monkeypatch.delenv('RESULT_DIR', raising=False)
        monkeypatch.delenv('EXPERIMENT_DIR', raising=False)
        if layout in ('RESULT_DIR', 'EXPERIMENT_DIR'):
            monkeypatch.setenv(layout, str(root / 'out'))
        argv = [str(hparams)] + (['--cloud'] if layout == 'cloud' else []) \
            + (['--benchmark'] if benchmark else [])
        args = run.build_argparser().parse_args(argv)
        config = _layout_config(root)
        result = run.resolve_result_dir(args, config, str(hparams))
        def rel(p, root=str(root)):
            return p if p is None or not p.startswith(root) else \
                os.path.relpath(p, root)
        config['current_dir'] = rel(config['current_dir'])
        config['agent']['data_save_dir'] = rel(
            config['agent']['data_save_dir'])
        got[side] = (rel(result), config, _record_files(str(root)))
    assert got['port'] == got['jax']
    if layout == 'RESULT_DIR':
        mode = 'experiments' if benchmark else 'traj_data'
        assert got['port'][0] == 'out/{}/lift/data/exp_2026_1_2_3_4'.format(
            mode)
        assert got['port'][2] == [got['port'][0] + '/hparams.py']
    if layout == 'cloud':
        assert got['port'][0] is None and \
            got['port'][1]['agent'] == {'data_save_dir': '/result/', 'T': 6}
        assert 'save_raw_images' not in got['port'][1]
    assert t_run._exp_name({'exp_name': 'x', 'agent': {}}) == 'x'
    assert t_run._exp_name({'agent': {'record': '/a/b/record/'}}) == \
        j_run._exp_name({'agent': {'record': '/a/b/record/'}}) == 'b'


def test_sync_thread_copies_and_stops_as_jax_does(tmp_path):
    src = tmp_path / 'src'
    (src / 'records' / 'train').mkdir(parents=True)
    (src / 'records' / 'train' / 'a.tfrecords').write_bytes(b'a')
    threads = {}
    for side, module in (('jax', j_sync), ('port', t_sync)):
        threads[side] = module.start_sync_thread(
            {'data_save_dir': str(src),
             'master_datadir': str(tmp_path / side)}, interval=0.05)
    for side in threads:
        assert _poll(lambda: os.path.isfile(
            tmp_path / side / 'records' / 'train' / 'a.tfrecords'))
    (src / 'records' / 'val').mkdir()
    (src / 'records' / 'val' / 'b.tfrecords').write_bytes(b'bb')
    threads['jax'].set()
    threads['port'].stop(timeout=30)
    assert not threads['port'].is_alive()
    want = _record_files(str(src))
    assert _record_files(str(tmp_path / 'port')) == want
    assert _poll(lambda: _record_files(str(tmp_path / 'jax')) == want)
    (src / 'late').write_bytes(b'c')        # after the stop: not copied
    time.sleep(0.2)
    assert _record_files(str(tmp_path / 'port')) == want
    assert (tmp_path / 'port' / 'records' / 'val' /
            'b.tfrecords').read_bytes() == b'bb'
