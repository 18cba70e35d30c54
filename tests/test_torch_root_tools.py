"""The port's twins of the root tools against the originals, on the CPU.

- ``tools/dataset_reader_demo.py`` beside ``examples/dataset_reader_demo.py``
  on ``tests/assets/ag_r4s_sample/good``: the same printed lines and the
  same ``dataset_demo.png`` bytes.
- ``tools/extract_sample_trajs.py`` beside ``scripts/extract_sample_trajs.py``
  on the same records: the same files, byte for byte (the gzip header's
  time stamp fixed on both sides).
- ``tools/collect_campaign.py`` beside ``scripts/collect_campaign.sh`` on a
  fake worker that logs ``(traj N)`` lines and dies once: the same log
  (the same restart index, messages and completion line), and the give-up
  exit after ``MAX_RESTARTS``.
- ``tools/bench_model.py --dry_run``: the ``Makefile``'s ``bench_model``
  recipe, step by step, on the port's runner and trainer, the trainer's
  flags the recipe's; collection left out where the records exist.
"""

import gzip
import importlib.util
import io
import os
import re
import shlex
import stat
import subprocess
import sys
from unittest import mock

import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.tools import (bench_model, collect_campaign,
                                          dataset_reader_demo,
                                          extract_sample_trajs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'tests', 'assets', 'ag_r4s_sample', 'good')


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_dataset_reader_demo_matches_the_original(tmp_path, monkeypatch):
    original = _load(os.path.join(REPO, 'examples', 'dataset_reader_demo.py'),
                     'jax_dataset_reader_demo')
    out = {}
    for side, run in (
            ('jax', lambda: original.main()),
            ('port', lambda: dataset_reader_demo.main([SAMPLE, '2']))):
        os.makedirs(str(tmp_path / side))
        monkeypatch.chdir(str(tmp_path / side))
        monkeypatch.setattr(sys, 'argv', ['demo', SAMPLE, '2'])
        buf = io.StringIO()
        with mock.patch('sys.stdout', buf):
            assert run() == 0
        with open('dataset_demo.png', 'rb') as f:
            out[side] = (buf.getvalue(), f.read())
    assert out['port'] == out['jax']
    text = out['port'][0]
    assert re.search(r'images: \(2, \d+, 1, 48, 64, 3\) uint8', text), text
    assert out['port'][1][:8] == b'\x89PNG\r\n\x1a\n'


def test_extract_sample_trajs_writes_the_originals_bytes(tmp_path):
    original = _load(os.path.join(REPO, 'scripts', 'extract_sample_trajs.py'),
                     'jax_extract_sample_trajs')
    files = {}
    for side, extract in (('jax', original.extract),
                          ('port', extract_sample_trajs.extract)):
        root = str(tmp_path / side)
        with mock.patch.object(gzip.time, 'time', lambda: 1700000000.0):
            assert extract(SAMPLE, root, 1) == 1
        files[side] = {
            os.path.relpath(os.path.join(d, f), root):
                open(os.path.join(d, f), 'rb').read()
            for d, _, fs in os.walk(root) for f in fs}
    assert files['port'] == files['jax']
    assert sorted(files['port']) == ['manifest.pkl', 'manifest.txt',
                                     'train/traj_0_to_0.tfrecords']


# a worker in place of the runner: it logs the indices it was given and one
# "(traj N)" line a trajectory; its first run dies after two of them
FAKE_WORKER = '''#!{python}
import os, sys
state = os.path.join({root!r}, 'runs')
n = int(open(state).read()) if os.path.exists(state) else 0
open(state, 'w').write(str(n + 1))
start = int(os.environ['VMPC_START_INDEX'])
end = int(os.environ['VMPC_END_INDEX'])
print('worker run {{}}: indices {{}} to {{}}'.format(n, start, end))
for i, traj in enumerate(range(start, end + 1)):
    print('taking sample {{}} of {{}} (traj {{}})'.format(i, end - start + 1,
                                                       traj))
    if n == 0 and i == 1 or {always_dies}:
        print('worker died at traj {{}}'.format(traj))
        sys.exit(3)
'''


def _fake_worker(root, name='python', always_dies=False):
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(FAKE_WORKER.format(python=sys.executable, root=root,
                                   always_dies=always_dies))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def test_collect_campaign_restarts_as_the_original(tmp_path):
    logs = {}
    for side in ('jax', 'port'):
        root = str(tmp_path / side)
        worker = _fake_worker(os.path.join(root, 'bin'))
        log = os.path.join(root, 'campaign.log')
        env = dict(os.environ, VMPC_START_INDEX='3')
        if side == 'jax':
            env['PATH'] = os.path.dirname(worker) + os.pathsep + env['PATH']
            rc = subprocess.call(['bash', os.path.join(
                REPO, 'scripts', 'collect_campaign.sh'), 'conf.py', '7', log],
                env=env)
        else:
            with mock.patch.dict(os.environ, env), \
                    mock.patch.object(collect_campaign, 'PYTHON', worker):
                rc = collect_campaign.main(['conf.py', '7', log])
        assert rc == 0
        with open(log) as f:
            logs[side] = f.read()
    assert logs['port'] == logs['jax']
    lines = logs['port'].splitlines()
    assert 'worker run 0: indices 3 to 7' in lines
    assert 'campaign: worker died rc=3; restarting at index 5 (restart 1)' \
        in lines
    assert 'worker run 1: indices 5 to 7' in lines
    assert lines[-1] == 'campaign: complete (end_index=7, restarts=1)'


def test_collect_campaign_gives_up(tmp_path, monkeypatch):
    worker = _fake_worker(str(tmp_path / 'bin'), always_dies=True)
    log = str(tmp_path / 'campaign.log')
    monkeypatch.setattr(collect_campaign, 'MAX_RESTARTS', 2)
    monkeypatch.setattr(collect_campaign, 'PYTHON', worker)
    monkeypatch.setenv('VMPC_START_INDEX', '0')
    # each run dies at its first trajectory: the same index again
    assert collect_campaign.main(['conf.py', '50', log]) == 1
    with open(log) as f:
        lines = f.read().splitlines()
    assert lines[-1] == 'campaign: giving up after 2 restarts (rc=3)'
    assert sum(l.startswith('worker run') for l in lines) == 3


def _makefile_train_flags():
    """The trainer's flags in the Makefile's ``bench_model`` recipe."""
    with open(os.path.join(REPO, 'Makefile')) as f:
        text = f.read().replace('\\\n', ' ')
    line = next(l for l in text.splitlines()
                if 'training.train_predictor' in l)
    argv = shlex.split(line)
    flags = argv[argv.index('visual_foresight_tpu.training.'
                            'train_predictor') + 1:]
    out, skip = [], False
    for i, a in enumerate(flags):
        if skip:
            skip = False
            continue
        if a in ('--data_dir', '--model_dir'):
            skip = True
            continue
        out.append(a)
    return out


@pytest.mark.parametrize('records', [False, True],
                         ids=['collects', 'records_exist'])
def test_bench_model_plans_the_makefile_recipe(tmp_path, records, capsys):
    root = str(tmp_path / 'data')
    if records:
        os.makedirs(os.path.join(root, 'collect', 'xz_r4', 'records', 'good',
                                 'train'))
        open(os.path.join(root, 'collect', 'xz_r4', 'records', 'good',
                          'train', 'traj_0_to_0.tfrecords'), 'w').close()
    assert bench_model.main(['--data_root', root, '--dry_run']) == 0
    steps = bench_model.plan(bench_model.build_argparser().parse_args(
        ['--data_root', root]))
    assert [s[0] for s in steps] == (['merge', 'train'] if records else
                                     ['collect', 'merge', 'train'])
    recs = os.path.join(root, 'collect', 'xz_r4', 'records')
    if not records:
        what, env, argv = steps[0]
        assert env == {'VMPC_DATA_DIR': os.path.join(root, 'collect',
                                                     'xz_r4')}
        assert argv[1:] == [
            '-m', 'visual_foresight_torch.tools.collect_campaign',
            bench_model.TWIN, '1099',
            os.path.join(root, 'collect', 'xz_r4_collect.log')]
    assert steps[-2][2][1:] == [bench_model.MERGE, recs]
    train = steps[-1][2]
    assert train[1:3] == ['-m',
                          'visual_foresight_torch.training.train_predictor']
    assert train[train.index('--data_dir') + 1] == os.path.join(recs, 'all')
    assert train[train.index('--model_dir') + 1] == os.path.join(
        root, 'models', 'xz_flagship')
    rest = train[3:]
    for flag in ('--data_dir', '--model_dir', '--device'):
        i = rest.index(flag)
        del rest[i:i + 2]
    assert rest == _makefile_train_flags()
    assert train[-2:] == ['--device', 'cuda']
    printed = capsys.readouterr().out.splitlines()
    assert [p.split(':')[0] for p in printed] == [s[0] for s in steps]
    # every flag the trainer reads
    from visual_foresight_torch.training import train_predictor
    args = train_predictor.build_argparser().parse_args(train[3:])
    assert (args.steps, args.batch_size, args.bf16, args.std_factor,
            list(args.enc_features), args.lstm_kernel, args.ss_k,
            args.ckpt_every) == (5000, 32, True, 4, [128, 256, 256], 3,
                                 300.0, 1000)
