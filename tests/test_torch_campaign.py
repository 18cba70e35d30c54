"""The port's benchmark campaign runner on the CPU, against the JAX package.

- ``python -m visual_foresight_torch.sim.run <twin config> --benchmark`` on
  each twin config (``campaigns/xz_bench20.py``, ``ag_bench20.py``) cut to
  two tasks (one for ag), T of 6, 16 samples and a seeded small predictor
  with ``device: 'cpu'``: the txt and pkl reports are written, each task's
  ``initial_dist`` (which no policy moves) equals the JAX campaign's
  (``benchmarks/*/runs/*/scores_0to19.pkl``) within 1e-6, and the
  controller dumped its plans through the agent's file worker.  In one
  worker, ``chip_smoke.check_campaign`` (the card's campaign gates) passes
  on the run's reports, replans and tail calls, and fails when a band is
  moved past them.  The same with two workers, started with ``spawn``.
- The twin configs carry the vendored configs' keys, values and
  ``VMPC_*`` overrides, with the port's classes and weights.
- ``write_scores`` and ``combine_scores`` write the same reports as JAX's
  on the same stats; without matplotlib the plots are skipped and the
  reports still written.
- ``skip_bad_trajs``: a task whose every retry fails drops out, and the
  report's task indices are compacted, as in the JAX package (whose
  ``perform_benchmark`` runs beside the port's on the same episodes, a
  fixed-action policy on ``xz_lifting_bench20``)."""

import contextlib
import copy
import filecmp
import os
import pickle

import numpy as np
import pytest

from test_torch_agent import FixedPolicy
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent import benchmarking_agent as t_bench
from visual_foresight_torch.agent.general_agent import (
    Bad_Traj_Exception as TBadTraj)
from visual_foresight_torch.envs.mujoco_env.cartgripper_env import (
    cartgripper_xz_grasp as t_xz)
from visual_foresight_torch.models import cdna as t_cdna
from visual_foresight_torch.sim import benchmarks as t_benchmarks
from visual_foresight_torch.sim import run as t_run
from visual_foresight_torch.sim.util import combine_score as t_score
from visual_foresight_tpu.agent import benchmarking_agent as j_bench
from visual_foresight_tpu.agent.general_agent import (
    Bad_Traj_Exception as JBadTraj)
from visual_foresight_tpu.envs.mujoco_env.cartgripper_env import (
    cartgripper_xz_grasp as j_xz)
from visual_foresight_tpu.sim import benchmarks as j_benchmarks
from visual_foresight_tpu.sim.util import combine_score as j_score

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, 'visual_foresight_torch', 'campaigns')
JAX_RUNS = {'xz_bench20': 'benchmarks/xz_bench20/runs/r5_s768',
            'ag_bench20': 'benchmarks/ag_bench20/runs/r5_v2'}
TINY = '''import copy
from visual_foresight_torch.sim.run import load_config
config = copy.deepcopy(load_config({twin!r}))
config['end_index'] = {end}
config['current_dir'] = {root!r}
config['agent'].update(T=6, data_save_dir={root!r} + '/results',
                       record={root!r} + '/record/', current_dir={root!r})
config['policy'].update(
    T=6, nactions=2, num_samples=16, device='cpu',
    model_path={root!r} + '/no_weights',
    predictor_hparams={{'std_factor': 4, 'num_masks': 2,
                        'enc_features': (8, 8, 8), 'dtype': 'float32',
                        'latent_dim': {latent}}})
'''


def _tiny_config(root, name, end):
    os.makedirs(str(root), exist_ok=True)
    path = os.path.join(str(root), 'tiny_{}.py'.format(name))
    with open(path, 'w') as f:
        f.write(TINY.format(
            twin=os.path.join(CAMPAIGNS, name + '.py'), end=end,
            root=str(root), latent=2 if name == 'ag_bench20' else 0))
    return path


def _jax_initial_dist(name, n):
    with open(os.path.join(REPO, JAX_RUNS[name], 'scores_0to19.pkl'),
              'rb') as f:
        return np.asarray(pickle.load(f)['initial_dist'])[:n]


@pytest.mark.parametrize('name,end,nworkers', [('xz_bench20', 1, 1),
                                               ('ag_bench20', 0, 1),
                                               ('xz_bench20', 1, 2)])
def test_campaign_runs_on_the_cpu(name, end, nworkers, tmp_path,
                                  monkeypatch):
    import chip_smoke
    config = _tiny_config(tmp_path, name, end)
    monkeypatch.setenv('OMP_NUM_THREADS', '2')   # the spawned workers' torch
    tail_calls = []

    def counted_tail(*args, **kwargs):
        tail_calls.append(1)
        return tail(*args, **kwargs)

    tail = t_cdna.fused_warp_composite
    monkeypatch.setattr(t_cdna, 'fused_warp_composite', counted_tail)
    clock = chip_smoke.ReplanClock(lambda: None)
    # the workers' warnings are their own (spawned processes)
    with pytest.warns(UserWarning, match='seeded random weights') \
            if nworkers == 1 else contextlib.nullcontext(), clock:
        result_dir = t_run.main([config, '--benchmark', '--nworkers',
                                 str(nworkers)])
    assert result_dir == str(tmp_path) + '/verbose'
    ranges = [(0, end)] if nworkers == 1 else [(0, 0), (1, 1)]
    stats = []
    for lo, hi in ranges:
        assert os.path.isfile(os.path.join(
            result_dir, 'results_{}to{}.txt'.format(lo, hi)))
        with open(os.path.join(result_dir, 'scores_{}to{}.pkl'.format(
                lo, hi)), 'rb') as f:
            stats.append(pickle.load(f))
    initial = np.concatenate([s['initial_dist'] for s in stats])
    assert sorted(stats[0]) == ['final_dist', 'improvement', 'initial_dist']
    np.testing.assert_allclose(initial, _jax_initial_dist(name, end + 1),
                               rtol=0, atol=1e-6)
    for s in stats:
        assert np.isfinite(s['final_dist']).all()
        np.testing.assert_allclose(s['improvement'],
                                   s['initial_dist'] - s['final_dist'])
    with open(os.path.join(result_dir, 'results_all.txt')) as f:
        report = f.read()
    assert 'average initial dist: {}'.format(np.mean(initial)) in report
    for task in range(end + 1):
        plans = os.path.join(str(tmp_path), 'results', 'verbose',
                             'traj_{}'.format(task), 'planning_1_itr_2')
        assert os.path.isfile(os.path.join(plans, 'plan.html'))
        with open(os.path.join(plans, 'cam_0_desig_0_0.gif'), 'rb') as f:
            assert f.read(6) == b'GIF89a'
    if nworkers > 1:
        return                 # the clock and the counter stay in this process
    hp = t_run.load_config(config)
    reference = _jax_initial_dist(name, 20)
    gate = dict(name=name, result_dir=result_dir, hp=hp,
                replans=len(clock.ms), launches=len(tail_calls),
                per_replan=chip_smoke.replan_launches(hp['policy']),
                floor=-np.inf, ref_initial=reference, atol=1e-6)
    assert clock.ms and clock.ctrls
    scores, gap = chip_smoke.check_campaign(**gate)
    assert gap <= 1e-6 and sorted(scores) == sorted(stats[0])
    mean = float(np.mean(scores['improvement']))
    for band, match in ((dict(floor=mean + 1e-3), 'mean improvement'),
                        (dict(launches=len(tail_calls) + 1), 'tail launches'),
                        (dict(ref_initial=reference + 1e-5), 're-created'),
                        (dict(hp=dict(hp, end_index=end + 1)), 'no results')):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_campaign(**dict(gate, **band))


@pytest.mark.parametrize('name', ['xz_bench20', 'ag_bench20'])
def test_twin_config_mirrors_the_vendored_one(name, monkeypatch):
    for key in ('VMPC_RESULT_DIR', 'VMPC_TASK_DIR', 'VMPC_MODEL_DIR',
                'VMPC_NUM_SAMPLES', 'VMPC_SAMPLE_CHUNK', 'VMPC_REPLAN',
                'VMPC_STD_LIFT'):
        monkeypatch.delenv(key, raising=False)
    twin = t_run.load_config(os.path.join(CAMPAIGNS, name + '.py'))
    with open(os.path.join(REPO, 'benchmarks', name, 'hparams.py')) as f:
        vendored_src = f.read()
    # the vendored config imports the JAX package: compare by its source
    for key in twin:
        assert "'{}'".format(key) in vendored_src, key
    assert twin['agent']['type'] is t_bench.BenchmarkAgent
    assert twin['policy']['type'].__module__.startswith(
        'visual_foresight_torch.')
    assert twin['agent']['env'][0].__module__.startswith(
        'visual_foresight_torch.envs.')
    assert twin['agent']['start_goal_confs'].endswith(
        {'xz_bench20': 'benchmarks/tasks/xz_lifting_bench20',
         'ag_bench20': 'benchmarks/tasks/ag_bench20'}[name])
    model = twin['policy']['model_path']
    assert os.path.isfile(os.path.join(model, 'view0', 'params.npz'))
    assert 'device' not in twin['policy']            # the card by default
    assert twin['policy']['num_samples'] == 768
    assert (twin['start_index'], twin['end_index']) == (0, 19)
    monkeypatch.setenv('VMPC_RESULT_DIR', '/elsewhere')
    monkeypatch.setenv('VMPC_MODEL_DIR', '/models/m')
    moved = t_run.load_config(os.path.join(CAMPAIGNS, name + '.py'))
    assert moved['agent']['data_save_dir'] == '/elsewhere/results'
    assert moved['policy']['model_path'] == '/models/m'


def _stats(n, lifted=False, seed=0):
    rng = np.random.RandomState(seed)
    initial = rng.uniform(0.2, 0.5, n)
    final = rng.uniform(0.0, 0.5, n)
    stats = {'improvement': initial - final, 'initial_dist': initial,
             'final_dist': final}
    if lifted:
        stats['lifted'] = rng.rand(n) > 0.5
        stats['term_t'] = rng.randint(3, 6, n)
    return stats


@pytest.mark.parametrize('lifted', [False, True])
def test_write_scores_equals_jax(lifted, tmp_path):
    conf = {'start_index': 3, 'agent': {'T': 6, 'term_dist': 0.1}}
    stats = _stats(7, lifted)
    out = {}
    for pkg, mod in (('port', t_score), ('jax', j_score)):
        out[pkg] = str(tmp_path / '{}.txt'.format(pkg))
        mod.write_scores(conf, out[pkg], stats, i_traj=9)
    assert filecmp.cmp(out['port'], out['jax'], shallow=False)


@pytest.mark.parametrize('plots', [True, False])
def test_combine_scores_equals_jax(plots, tmp_path, monkeypatch, capsys):
    conf = {'start_index': 0, 'agent': {'T': 6}}
    dirs = {}
    for pkg in ('port', 'jax'):
        dirs[pkg] = str(tmp_path / pkg)
        os.makedirs(dirs[pkg])
        for i, (lo, hi) in enumerate([(0, 4), (5, 9), (10, 12)]):
            with open(os.path.join(dirs[pkg], 'scores_{}to{}.pkl'.format(
                    lo, hi)), 'wb') as f:
                pickle.dump(_stats(hi - lo + 1, seed=i), f)
    if not plots:
        monkeypatch.setattr(t_score, '_pyplot', lambda: None)
    got = t_score.combine_scores(conf, dirs['port'])
    want = j_score.combine_scores(conf, dirs['jax'])
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key])
    for name in ('results_all.txt', 'finaldist_histo.txt',
                 'improvement_histo.txt'):
        assert filecmp.cmp(os.path.join(dirs['port'], name),
                           os.path.join(dirs['jax'], name), shallow=False)
    pngs = ('finaldist.png', 'improvement.png', 'imp_vs_dist.png')
    assert all(os.path.isfile(os.path.join(dirs['port'], p)) == plots
               for p in pngs)
    if not plots:
        assert 'the score plots were skipped' in capsys.readouterr().out


def _skipping_agent(base, bad_exc):
    class SkippingAgent(base):
        """Every retry of task 1 fails."""

        def sample(self, policy, i_traj):
            if i_traj == 1:
                raise bad_exc('task 1 cannot be produced')
            return base.sample(self, policy, i_traj)
    return SkippingAgent


class FixedPolicyCtor(FixedPolicy):
    """``FixedPolicy`` built as the runner builds a policy."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        super().__init__(policyparams['actions'])


@pytest.mark.parametrize('skip', [True, False])
def test_skip_bad_trajs_compacts_as_jax_does(skip, tmp_path):
    from test_torch_envs import TASKS, XZ_PARAMS
    actions = np.random.RandomState(9).uniform(-0.05, 0.05, (3, 3))
    reports = {}
    for pkg, bench, env, bad, driver in (
            ('port', t_bench.BenchmarkAgent, t_xz.CartgripperXZGrasp,
             TBadTraj, t_benchmarks),
            ('jax', j_bench.BenchmarkAgent, j_xz.CartgripperXZGrasp,
             JBadTraj, j_benchmarks)):
        root = str(tmp_path / pkg)
        conf = {'start_index': 0, 'end_index': 2, 'result_dir': root,
                'skip_bad_trajs': skip,
                'agent': {'type': _skipping_agent(bench, bad),
                          'env': (env, dict(XZ_PARAMS)),
                          'data_save_dir': root, 'T': 3,
                          'image_height': 48, 'image_width': 64,
                          'start_goal_confs': os.path.join(
                              TASKS, 'xz_lifting_bench20'),
                          'current_dir': root},
                'policy': {'type': FixedPolicyCtor, 'actions': actions},
                'save_data': False}
        if skip:
            driver.perform_benchmark(copy.deepcopy(conf))
        else:
            with pytest.raises(bad):
                driver.perform_benchmark(copy.deepcopy(conf))
        reports[pkg] = root
    report = os.path.join(reports['port'], 'results_0to2.txt')
    if not skip:                     # task 0's report, before the raise
        assert filecmp.cmp(report, os.path.join(
            reports['jax'], 'results_0to2.txt'), shallow=False)
        return
    assert filecmp.cmp(report, os.path.join(reports['jax'],
                                            'results_0to2.txt'),
                       shallow=False)
    with open(os.path.join(reports['port'], 'scores_0to2.pkl'), 'rb') as f:
        got = pickle.load(f)
    with open(os.path.join(reports['jax'], 'scores_0to2.pkl'), 'rb') as f:
        want = pickle.load(f)
    assert pickle.dumps(got) == pickle.dumps(want)
    # tasks 0 and 2 ran; the report lists them as 0 and 1
    assert got['initial_dist'].shape == (2,)
    np.testing.assert_allclose(
        got['initial_dist'], _jax_initial_dist('xz_bench20', 3)[[0, 2]],
        rtol=0, atol=1e-6)
    with open(report) as f:
        rows = [line.split(':')[0] for line in f.read().split(
            'traj: improv, final_d, rank\n----------------------\n')[1]
            .splitlines()]
    assert rows == ['0', '1']
