"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

- configuration: the file its entry names
  (``perfbench/configs/<config>.json``);
- traffic mix: ``perfbench/traffic/<traffic>.json``;
- limits of the comparison behind ``correct``:
  ``perfbench/limits/<cell>.json``;
- each metric: the module ``perfbench/metrics/<name>.py`` (``.`` and ``-``
  in a name become ``_``), whose ``read(ctx)`` returns the value or None;
- operation and byte counts: the module ``perfbench/counts/<config>.py``;
- architecture: the module ``perfbench/archs/<config>.py``, whose
  ``param_specs(cfg)`` names the weights the generator makes and whose
  ``Reference`` the comparison behind ``correct`` drives
  (``perfbench/reference/planner.py`` says what it gives);
  ``PUBLISHED_CONFIG``, the path in the repo of the published
  ``model_config.json`` that the configuration copies, and
  ``PUBLISHED_PARAMS``, its published parameter count, are what the CPU
  tests hold the configuration and the weights' table against.
"""

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _load(os.path.join(root, 'BENCHMARK.json'))


def module_name(name):
    return name.replace('.', '_').replace('-', '_')


def metric_reader(name):
    return importlib.import_module('perfbench.metrics.' + module_name(name))


def counts(config):
    return importlib.import_module('perfbench.counts.' + module_name(config))


def arch(config):
    """The architecture module of ``config``; fails, naming the file to
    add, where there is none."""
    name = 'perfbench.archs.' + module_name(config)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(
            'configuration {} has no architecture: add perfbench/archs/{}.py'
            ' with param_specs(cfg), Reference, PUBLISHED_CONFIG and'
            ' PUBLISHED_PARAMS'.format(
                config, module_name(config)), name=name) from None


def metrics_of(entries, cell):
    """The metric entries that ``cell`` reports: those without a
    ``workloads`` key and those whose key names it."""
    return [m for m in entries if cell in m.get('workloads', (cell,))]


def resolve(bench, name, root=ROOT):
    """Everything a run of cell ``name`` needs, as a dict: 'cell', 'cfg',
    'traffic', 'limits', 'arch', 'counts', 'end_to_end' and 'per_layer'
    (the metric entries it reports)."""
    cells = {c['name']: c for c in bench['workloads']}
    if name not in cells:
        raise KeyError('no workload {} in BENCHMARK.json (have {})'.format(
            name, sorted(cells)))
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    cfg = _load(os.path.join(root, configs[cell['config']]['file']))
    return {
        'cell': cell, 'cfg': cfg,
        'traffic': _load(os.path.join(root, 'perfbench', 'traffic',
                                      cell['traffic'] + '.json')),
        'limits': _load(os.path.join(root, 'perfbench', 'limits',
                                     name + '.json')),
        'arch': arch(cell['config']),
        'counts': counts(cell['config']),
        'end_to_end': metrics_of(bench['end_to_end'], name),
        'per_layer': metrics_of(bench['per_layer'], name),
    }
