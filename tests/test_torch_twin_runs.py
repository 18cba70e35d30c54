"""The benchmark twins of the port run through ``sim/run.py --benchmark``
on the CPU, beside the JAX package's runs.

- Task 0 of each benchmark twin whose controller no other test runs
  through the runner (hard, classifier, both ensembles, registration,
  NCE, both inverse baselines and the three random baselines), cut to T 6,
  2 actions, 16 samples and the tiny predictor of
  ``test_torch_campaign.py`` on ``device: 'cpu'``: its ``initial_dist``
  (which no policy moves) is within 1e-6 of the JAX run vendored beside
  the source, every replan's tail calls equal the count from the cut
  policy, and a random twin's ``final_dist`` equals the JAX package's run
  of its own source, cut the same way, under the same seeds.
- The 2D grasping task generator ``sim_2d_grasping_create_configs`` writes
  one task that the pixel-cost twin ``sim_2d_grasping_pixel_cost`` (the
  default-equal ``repeat`` key dropped, as a user must) then plans.  The
  ensemble experiment's generator ``sim_ensemble_grasping_tasks`` raises
  as its JAX source does.
"""

import os
import pickle
import random

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models import cdna as t_cdna
from visual_foresight_torch.sim import run as t_run
from visual_foresight_tpu.sim import run as j_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, 'visual_foresight_torch', 'campaigns')
SEED = 5
GEN_SEED = 0
TINY = {'std_factor': 4, 'num_masks': 2, 'enc_features': (8, 8, 8),
        'dtype': 'float32'}
N_SAMPLES, NACT, T_CUT, ITERS = 16, 2, 6, 3
CUT = '''import copy
from {pkg}.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
config['end_index'] = 0
config['current_dir'] = {root!r}
config['agent'].update(T={T}, data_save_dir={root!r} + '/results',
                       record={root!r} + '/record/', current_dir={root!r},
                       **{agent!r})
config['policy'].update({policy!r})
for key in {drop!r}:
    del config['policy'][key]
'''
# a task generator's config cut to one task written under root
GEN_CUT = '''import copy
from {pkg}.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
config['end_index'] = 0
config['current_dir'] = {root!r}
config['agent']['data_save_dir'] = {root!r}
'''
# twin -> (the JAX report of task 0's initial_dist, the cut of its policy:
# 'plan' a CEM controller on the tiny predictor, 'members' the same with a
# member list, 'inverse' or 'random'; the VMPC_* variables of the run)
RUNS = {
    'ag_bench20_hard': ('benchmarks/ag_bench20_hard/verbose', 'plan',
                        {'VMPC_STOCH_K': '2', 'VMPC_STOCH_PEN': '1.0'}),
    'ag_bench20_classifier': ('benchmarks/ag_bench20_classifier/runs/r5_v1',
                              'plan', {}),
    'ag_bench20_ensemble': ('benchmarks/ag_bench20_ensemble/verbose',
                            'members', {}),
    'xz_bench20_ensemble': ('benchmarks/xz_bench20_ensemble/verbose',
                            'members', {}),
    'xz2c_bench20_registration': (
        'benchmarks/xz2c_bench20_registration/runs/r5', 'plan', {}),
    'xz_bench20_nce': ('benchmarks/xz_bench20_nce/verbose', 'plan', {}),
    # no run vendored beside the source: xz_bench20's, on the same tasks
    'xz_bench20_inverse': ('benchmarks/xz_bench20/runs/r5_s768', 'inverse',
                           {}),
    'ag_bench20_inverse': ('benchmarks/ag_bench20_inverse/runs/r5_v1',
                           'inverse', {}),
    'xz_bench20_random': ('benchmarks/xz_bench20_random/verbose', 'random',
                          {}),
    'xz2c_bench20_random': ('benchmarks/xz2c_bench20_random/verbose',
                            'random', {}),
    # the report beside the source (results_ag_bench20/verbose) reads task
    # 0's initial_dist 3.0e-6 lower, as the JAX run r5_v1 does: an earlier
    # JAX package's; the JAX package of this repo (run below) and the port
    # reproduce r5_v2's
    'ag_bench20_random': ('benchmarks/ag_bench20/runs/r5_v2', 'random', {}),
}


def _source(name):
    return os.path.join(REPO, 'benchmarks', name, 'hparams.py')


def _members(root, n, latent):
    """``n`` member directories on seeded weights at the tiny widths."""
    import json
    paths = []
    for i in range(n):
        path = os.path.join(root, 'member{}'.format(i))
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, 'model_config.json'), 'w') as f:
            json.dump(dict(TINY, enc_features=list(TINY['enc_features']),
                           latent_dim=latent), f)
        paths.append(path)
    return paths


def _policy_cut(kind, policy, root, latent):
    if kind == 'random':
        return {'nactions': NACT}
    if kind == 'inverse':
        return {'T': T_CUT, 'device': 'cpu'}
    cut = {'T': T_CUT, 'nactions': NACT, 'num_samples': N_SAMPLES,
           'device': 'cpu',
           'predictor_hparams': dict(policy.get('predictor_hparams') or {},
                                     latent_dim=latent, **TINY)}
    cut['model_path'] = _members(root, len(policy['model_path']), latent) \
        if kind == 'members' else os.path.join(root, 'no_weights')
    return cut


def _write_cut(root, pkg, src, config, kind, agent=None, drop=()):
    """A config file at ``root`` that loads ``src`` with ``pkg``'s loader
    and cuts it: task 0, T 6 and the policy's cut."""
    os.makedirs(root, exist_ok=True)
    latent = 2 if config['agent']['env'][0].__name__.startswith(
        'Autograsp') else 0
    path = os.path.join(root, 'cut.py')
    with open(path, 'w') as f:
        f.write(CUT.format(pkg=pkg, src=src, root=root, T=T_CUT,
                           agent=agent or {}, drop=tuple(drop),
                           policy=_policy_cut(kind, config['policy'], root,
                                              latent)))
    return path


def _pin_seeds(monkeypatch, value):
    for module in (np.random, random):
        seed = getattr(module.seed, 'unpinned', module.seed)
        pinned = lambda s=None, _seed=seed: _seed(value if s is None else s)
        pinned.unpinned = seed
        monkeypatch.setattr(module, 'seed', pinned)


@pytest.fixture
def fixed_worker_seeds(monkeypatch):
    """The runner's worker seeds the global streams with None; here with
    ``SEED``, on both sides."""
    _pin_seeds(monkeypatch, SEED)


def _counted_tail(monkeypatch):
    calls = []
    tail = t_cdna.fused_warp_composite

    def counted(*args, **kwargs):
        calls.append(1)
        return tail(*args, **kwargs)
    monkeypatch.setattr(t_cdna, 'fused_warp_composite', counted)
    return calls


def _per_replan(kind, ctrl, ncam):
    """Tail calls of one replan, from the controller's own values: an
    ensemble member's teacher-forced forward over the context action and
    the plan a member and iteration; else a rollout of the plan a camera
    and iteration after one context step a camera."""
    hp = ctrl._hp
    rows = hp.num_samples * (hp.stochastic_planning or (1,))[0] \
        if 'stochastic_planning' in hp else hp.num_samples
    assert rows in (N_SAMPLES, 2 * N_SAMPLES)
    if kind == 'members':
        return hp.num_ensembles * hp.iterations * (1 + hp.T)
    return ncam * (1 + hp.iterations * hp.T)


def _scores(result_dir):
    with open(os.path.join(result_dir, 'scores_0to0.pkl'), 'rb') as f:
        return pickle.load(f)


def _run(run, config, tmp_root):
    np.random.seed(SEED)
    random.seed(SEED)
    result_dir = run.main([config, '--benchmark'])
    assert result_dir == tmp_root + '/verbose'
    return _scores(result_dir)


@pytest.mark.parametrize('name', sorted(RUNS))
def test_benchmark_twin_runs_task_0(name, tmp_path, monkeypatch,
                                    fixed_worker_seeds):
    import chip_smoke
    report, kind, env = RUNS[name]
    for key in [k for k in os.environ if k.startswith('VMPC_')]:
        monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    twin = os.path.join(CAMPAIGNS, name + '.py')
    config = t_run.load_config(twin)
    root = str(tmp_path / 'port')
    cut = _write_cut(root, 'visual_foresight_torch', twin, config, kind)
    calls = _counted_tail(monkeypatch)
    clock = chip_smoke.ReplanClock(lambda: None,
                                   cls=config['policy']['type']) \
        if kind in ('plan', 'members') else None
    if clock:
        with clock:
            stats = _run(t_run, cut, root)
    else:
        stats = _run(t_run, cut, root)
    with open(os.path.join(REPO, report, 'scores_0to19.pkl'), 'rb') as f:
        want = np.asarray(pickle.load(f)['initial_dist'])[:1]
    np.testing.assert_allclose(stats['initial_dist'], want, rtol=0,
                               atol=1e-6)
    assert np.isfinite(stats['final_dist']).all()
    if clock:
        ncam = config['agent']['env'][1].get('ncam', 1)
        per_replan = _per_replan(kind, clock.ctrls[0], ncam)
        assert len(clock.ms) >= 1
        assert len(calls) == len(clock.ms) * per_replan, (len(calls),
                                                          len(clock.ms))
    else:
        assert calls == []
    if kind != 'random':
        return
    # the JAX package's run of the source, cut the same way
    jax_root = str(tmp_path / 'jax')
    jax_cut = _write_cut(jax_root, 'visual_foresight_tpu', _source(name),
                         j_run.load_config(_source(name)), kind)
    want = _run(j_run, jax_cut, jax_root)
    for key in ('initial_dist', 'final_dist', 'improvement'):
        assert np.array_equal(stats[key], want[key]), key


def _generator_cut(root, pkg, src):
    os.makedirs(root)
    path = os.path.join(root, 'cut.py')
    with open(path, 'w') as f:
        f.write(GEN_CUT.format(pkg=pkg, src=src, root=root))
    return path


def test_ensemble_task_generator_raises_as_jax_does(tmp_path,
                                                     fixed_worker_seeds):
    """``generate_tasks.py`` of the ensemble experiment cannot make a task
    in either package: the config agent moves the arm with a 5-dim action
    (``cartgripper_rot_grasp.py::_move_arm``) and the autograsp env takes 4
    (``autograsp_env.py::_next_qpos`` asserts)."""
    for pkg, run, src in (
            ('visual_foresight_tpu', j_run, os.path.join(
                REPO, 'experiments/sim/ensemble_grasping/generate_tasks.py')),
            ('visual_foresight_torch', t_run, os.path.join(
                CAMPAIGNS, 'sim_ensemble_grasping_tasks.py'))):
        cut = _generator_cut(str(tmp_path / pkg), pkg, src)
        np.random.seed(SEED)
        with pytest.raises(AssertionError) as err:
            run.main([cut])
        assert err.traceback[-1].name == '_next_qpos'


def test_generated_task_is_planned(tmp_path, monkeypatch,
                                   fixed_worker_seeds):
    """The 2D grasping generator ``sim_2d_grasping_create_configs`` writes
    ``<data_save_dir>/train/traj_group0/traj0`` (two frames, the reset
    state, the object poses); the pixel-cost twin reads
    ``$VMPC_DATA_DIR/cartgripper_xz_grasp/lifting_tasks/raw/traj_group0/
    traj0``, here the generator's ``train/`` linked there, and plans it
    (the default-equal ``repeat`` dropped, as a user must)."""
    for key in [k for k in os.environ if k.startswith('VMPC_')]:
        monkeypatch.delenv(key)
    gen = str(tmp_path / 'gen')
    cut = _generator_cut(gen, 'visual_foresight_torch', os.path.join(
        CAMPAIGNS, 'sim_2d_grasping_create_configs.py'))
    # the generator re-places the block until a grasp holds, with no bound
    # on the tries (as in the JAX package): under some seeds that takes
    # minutes; under GEN_SEED one try
    _pin_seeds(monkeypatch, GEN_SEED)
    t_run.main([cut])
    _pin_seeds(monkeypatch, SEED)
    task = os.path.join(gen, 'train', 'traj_group0', 'traj0')
    assert sorted(os.listdir(os.path.join(task, 'images0'))) == [
        'im_0.png', 'im_1.png']
    data = str(tmp_path / 'data')
    os.makedirs(os.path.join(data, 'cartgripper_xz_grasp', 'lifting_tasks'))
    os.symlink(os.path.join(gen, 'train'), os.path.join(
        data, 'cartgripper_xz_grasp', 'lifting_tasks', 'raw'))
    monkeypatch.setenv('VMPC_DATA_DIR', data)
    twin = os.path.join(CAMPAIGNS, 'sim_2d_grasping_pixel_cost.py')
    config = t_run.load_config(twin)
    assert config['agent']['start_goal_confs'] == os.path.join(
        data, 'cartgripper_xz_grasp', 'lifting_tasks', 'raw')
    root = str(tmp_path / 'plan')
    cut = _write_cut(root, 'visual_foresight_torch', twin, config, 'plan',
                     drop=('repeat',))
    calls = _counted_tail(monkeypatch)
    import chip_smoke
    with chip_smoke.ReplanClock(lambda: None,
                                cls=config['policy']['type']) as clock:
        stats = _run(t_run, cut, root)
    ctrl = clock.ctrls[0]
    assert ctrl._hp.num_samples == N_SAMPLES and ctrl._hp.repeat == 3
    assert len(calls) == len(clock.ms) * _per_replan('plan', ctrl, 1)
    assert np.isfinite(stats['initial_dist']).all() and \
        np.isfinite(stats['final_dist']).all()


@pytest.mark.parametrize('task_set', ['ag_bench20', 'ag_bench20_hard',
                                      'xz2c_bench20'])
def test_smoke_task0_tables_are_the_envs(task_set):
    """``chip_smoke.py`` plans the benchmark twins on task 0 without
    MuJoCo: the designated pixels, goal pixels and state of
    ``chip_smoke.TASK0`` are the port env's at reset from the task's reset
    state."""
    import chip_smoke
    from visual_foresight_torch.agent.goal_sources import (
        TrajectoryFolderGoalSource)
    from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
        autograsp_env, cartgripper_xz_grasp)
    config = t_run.load_config(os.path.join(CAMPAIGNS, {
        'ag_bench20': 'ag_bench20_classifier.py',
        'ag_bench20_hard': 'ag_bench20_hard.py',
        'xz2c_bench20': 'xz2c_bench20_registration.py'}[task_set]))
    env_cls, params = config['agent']['env']
    assert env_cls in (autograsp_env.AutograspCartgripperEnv,
                       cartgripper_xz_grasp.CartgripperXZGrasp)
    ncam = params.get('ncam', 1)
    hp = {'start_goal_confs': os.path.join(REPO, 'benchmarks', 'tasks',
                                           task_set),
          'image_height': 48, 'image_width': 64, 'data_save_dir': '/unused'}
    spec = TrajectoryFolderGoalSource(hp, ncam=ncam).load(0)
    env = env_cls(params, spec.reset_state)
    try:
        env.set_goal_obj_pose(spec.goal_obj_pose)
        obs, _ = env.reset()
        desig, goal, state = chip_smoke.TASK0[task_set]
        scale = 64 / obs['images'].shape[2]
        assert np.array_equal(
            np.round(obs['obj_image_locations'] * scale).astype(np.int64),
            desig)
        assert np.array_equal(env.get_goal_pix(64), goal)
        assert np.array_equal(obs['state'], state)
    finally:
        env.close()
