"""BENCHMARK.json against the benchmark's contract, and every cell's parts
found by name."""

import json
import os
import re

import pytest
import torch

from perfbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def test_keys_and_names():
    assert set(BENCH) == KEYS['top']
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    for group, kind in (('configs', 'config'), ('workloads', 'workload'),
                        ('end_to_end', 'end_to_end'),
                        ('per_layer', 'per_layer')):
        names = [e['name'] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert set(e) - {'workloads'} == KEYS[kind], e['name']
            assert NAME.match(e['name']), e['name']
            for text in ('why', 'layer', 'source'):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and '\n' not in e[text]
            if 'unit' in e:
                assert UNIT.match(e['unit']), e['unit']
                assert e['better'] in ('lower', 'higher')
            for cell in e.get('workloads', ()):
                assert cell in CELLS


def test_bounds_and_run_length():
    assert 1 <= BENCH['run_seconds'] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert {m['name'] for m in BENCH['end_to_end']} >= {'setup_s'}
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e


@pytest.mark.parametrize('cell', CELLS)
def test_cell_parts_found_by_name(cell):
    parts = spec.resolve(BENCH, cell)
    assert parts['cell']['chips'] == 1
    names = {m['name'] for m in parts['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert parts['per_layer']
    for m in parts['end_to_end'] + parts['per_layer']:
        assert callable(spec.metric_reader(m['name']).read)
    assert callable(parts['counts'].step_flops)
    assert callable(parts['counts'].tail_cost)
    assert parts['arch'] is spec.arch(parts['cell']['config'])
    traffic = parts['traffic']
    limits = parts['limits']
    assert {'score_noise', 'plan_gap'} <= set(limits)
    assert ('distrib_noise' in limits) == traffic['predictor_propagation']


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_copies_the_model_config(config):
    """Every key of the published ``model_config.json`` that the
    configuration's architecture module names is in the configuration
    file, unchanged (``reduced`` is empty).  The published file lies
    outside the program's package: the program's own files are never the
    yardstick."""
    with open(os.path.join(ROOT, config['file'])) as f:
        cfg = json.load(f)
    published = spec.arch(config['name']).PUBLISHED_CONFIG
    assert not published.startswith('visual_foresight_torch/'), published
    path = os.path.join(ROOT, published)
    assert os.path.isfile(path), 'configuration {}: no published config at' \
        ' {}'.format(config['name'], published)
    with open(path) as f:
        source = json.load(f)
    assert config['reduced'] == []
    for key, value in source.items():
        assert cfg[key] == value, key
    assert config['file'].startswith(BENCH['paths'][0] + '/')


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_weights_load_into_the_program(config):
    """The table of weights of the configuration's architecture module
    names every tensor of the program's predictor, built on the meta
    device, in its order, at its shape and served type."""
    from perfbench.generator import DTYPES
    from perfbench.program import build_model
    with open(os.path.join(ROOT, config['file'])) as f:
        cfg = json.load(f)
    specs = spec.arch(config['name']).param_specs(cfg)
    traffic = {'designated_pixels': 1}
    with torch.device('meta'):
        weights = {n: torch.empty(s[0], dtype=DTYPES[cfg['dtype']]
                                  if s[3] == 'compute' else torch.float32)
                   for n, s in specs.items()}
    model = build_model(cfg, traffic, weights, torch.device('meta'))
    state = model.state_dict()
    assert list(state) == list(specs)
    for n, s in specs.items():
        assert tuple(state[n].shape) == s[0], n
    total = sum(int(torch.tensor(s[0]).prod()) for s in specs.values())
    assert total == spec.arch(config['name']).PUBLISHED_PARAMS
