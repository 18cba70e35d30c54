"""A configuration's architecture found by its name: a second one added
from new files alone and driven end to end, the failure where a
configuration has none, and the readings that finding it by name must not
move (the weights from a seed, the numbers behind ``correct``)."""

import hashlib
import json
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import perfbench.archs
import perfbench.counts
from perfbench import run as run_lib
from perfbench import spec
from perfbench.generator import Workload, make_weights, model_steps
from perfbench.program import Program
from perfbench.tests import tiny

CPU = torch.device('cpu')
SECOND = 'second_backbone'

ARCH = '''
"""A second architecture, written as a later configuration would write
it; it records what drove it."""

from perfbench.reference import model

driven = []


def param_specs(cfg):
    driven.append('param_specs')
    return model.param_specs(cfg)


class Reference(model.Reference):
    def encode(self, images, distribs, states, actions):
        driven.append('encode')
        return super().encode(images, distribs, states, actions)

    def rollout(self, carry, plans, latents=None):
        driven.append('rollout')
        return super().rollout(carry, plans, latents)
'''

COUNTS = '''
from perfbench.counts.s2d_cdna import step_flops, tail_cost  # noqa: F401
'''

# make_weights at seed 12345 on the CPU, the names, types, shapes and bytes
# of every tensor in order, as the harness made them before it found the
# architecture by the configuration's name
WEIGHTS_SHA256 = {
    'xz_flagship':
        'ed3afa2767b9ca9f0c7c29301f5229850dd6ef5a6cda3b05157eea2f13ed2d81',
    'ag_r5f_v2':
        '6531f7fbfe7f86f94b09b930f395d9c981c0e1aaf61fc7aec2c0a3e131fb7682',
}
# the tiny cell's numbers behind ``correct`` over four replans at
# tiny.SEED, as the harness read them before that change
TINY_CHECKS = {'distrib_noise': 1.681713375837603, 'plan_gap': 0.0,
               'score_noise': 1.3589843196466178}


def lay_out(root, config, traffic='tiny'):
    """A benchmark under ``root`` with one cell, ``<config>.<traffic>``, of
    the tiny configuration, mix and limits."""
    for sub in ('traffic', 'limits'):
        (root / 'perfbench' / sub).mkdir(parents=True, exist_ok=True)
    cell = '{}.{}'.format(config, traffic)
    files = {'{}.json'.format(config): 'tiny_config.json',
             'perfbench/traffic/{}.json'.format(traffic): 'tiny_traffic.json',
             'perfbench/limits/{}.json'.format(cell): 'tiny_limits.json'}
    for path, source in files.items():
        (root / path).write_text(json.dumps(tiny.load(source)))
    bench = spec.benchmark()
    return cell, {
        'configs': [{'name': config, 'file': '{}.json'.format(config)}],
        'workloads': [{'name': cell, 'config': config, 'traffic': traffic,
                       'chips': 1}],
        'end_to_end': bench['end_to_end'], 'per_layer': bench['per_layer']}


@pytest.fixture
def new_files(tmp_path, monkeypatch):
    """The second architecture's modules, in a directory of their own put
    on the packages' paths; forgotten again afterwards."""
    for package, text in ((perfbench.archs, ARCH),
                          (perfbench.counts, COUNTS)):
        where = tmp_path / package.__name__.split('.')[-1]
        where.mkdir()
        (where / (SECOND + '.py')).write_text(textwrap.dedent(text))
        monkeypatch.setattr(package, '__path__',
                            list(package.__path__) + [str(where)])
    yield tmp_path
    for package in ('perfbench.archs.', 'perfbench.counts.'):
        sys.modules.pop(package + SECOND, None)


def test_second_architecture_from_new_files_alone(new_files):
    cell, bench = lay_out(new_files, SECOND)
    parts = spec.resolve(bench, cell, root=str(new_files))
    arch = parts['arch']
    assert arch.__name__ == 'perfbench.archs.' + SECOND
    assert set(parts['counts'].__dict__) >= {'step_flops', 'tail_cost'}
    torch.manual_seed(0)
    result = run_lib.run_cell(parts, tiny.SEED, 0.5, 0, CPU,
                              time.perf_counter())
    assert result['correct'] is True and result['failed'] == 0
    assert set(result['metrics']) == {'replan_ms', 'setup_s'}
    # its own table made the weights and its own Reference was checked
    assert arch.driven[0] == 'param_specs'
    assert {'encode', 'rollout'} <= set(arch.driven)


def test_configuration_without_an_architecture_fails_in_resolve(tmp_path):
    cell, bench = lay_out(tmp_path, 'no_backbone')
    with pytest.raises(ModuleNotFoundError,
                       match='perfbench/archs/no_backbone.py'):
        spec.resolve(bench, cell, root=str(tmp_path))


def digest(weights):
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize('config', sorted(WEIGHTS_SHA256))
def test_weights_are_those_made_before(config):
    with open('{}/perfbench/configs/{}.json'.format(spec.ROOT, config)) as f:
        cfg = json.load(f)
    weights = make_weights(cfg, 12345, CPU, spec.arch(config))
    assert digest(weights) == WEIGHTS_SHA256[config]


class Clock:
    """A clock that moves one second at each reading: a window of ``s``
    seconds holds ``s`` replans, whatever the CPU's speed."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now


def test_tiny_checks_are_those_read_before(monkeypatch):
    monkeypatch.setattr(run_lib, 'time', Clock())
    torch.manual_seed(0)
    result = run_lib.run_cell(tiny.parts(), tiny.SEED, 4.0, 0, CPU, 0.0)
    assert result['attempted'] == 4
    assert result['checked_replans'] == [0, 1]
    got = {n: c['value'] for n, c in result['checks'].items()}
    assert got == TINY_CHECKS


@pytest.mark.parametrize('chunk', [4, 12])
def test_chunked_tiny_cell_is_correct(chunk):
    """Chunks of 4 of the 12 samples, and a chunk of all 12, which the
    planner rolls as one batch."""
    result = tiny.run(seconds=0.5, sample_chunk=chunk)
    assert result['correct'] is True and result['failed'] == 0


def test_chunked_scores_are_the_unchunked():
    """The same replans rolled in chunks of 4 samples and in one batch of
    12: every score within 1e-6 of the largest."""
    parts = tiny.parts(sample_chunk=4)
    cfg, chunked = parts['cfg'], parts['traffic']
    whole = dict(chunked, sample_chunk=0)
    work = Workload(cfg, chunked, tiny.SEED, CPU, parts['arch'])
    assert work.vis_latents is not None
    progs = [Program(cfg, t, work.weights, CPU) for t in (whole, chunked)]
    carried = None
    for i in range(4):
        x = work.inputs(i, carried)
        want, got = (p.replan(x) for p in progs)
        scale = float(np.abs(want['scores']).max())
        assert float(np.abs(got['scores'] - want['scores']).max()) <= \
            1e-6 * scale
        assert np.array_equal(got['best_actions'], want['best_actions'])
        carried = np.swapaxes(want['best_distribs'][-2:], 0, 1)


@pytest.mark.parametrize('chunk', [0, 4, 12])
def test_model_steps_are_the_steps_a_replan_takes(chunk, monkeypatch):
    """``model_steps``, which the step metrics divide by and count FLOPs
    over, against the predictor steps of one replan, chunked or not."""
    from visual_foresight_torch.models.cdna import CDNAStep
    parts = tiny.parts(sample_chunk=chunk)
    cfg, traffic = parts['cfg'], parts['traffic']
    work = Workload(cfg, traffic, tiny.SEED, CPU, parts['arch'])
    prog = Program(cfg, traffic, work.weights, CPU)
    batches = []
    forward = CDNAStep.forward

    def counted(self, carry, x, *args, **kw):
        batches.append((x if torch.is_tensor(x) else x[0]).shape[0])
        return forward(self, carry, x, *args, **kw)
    monkeypatch.setattr(CDNAStep, 'forward', counted)
    prog.replan(work.inputs(0))
    implied = {}
    for b, n in model_steps(cfg, traffic):
        implied[b] = implied.get(b, 0) + n
    assert {b: batches.count(b) for b in batches} == implied
