"""The harness end to end on the CPU at a tiny size, the guard against the
reference package, and the reduction of a trace."""

import json
import os
import subprocess
import sys
import textwrap

from perfbench import isolation, spec, trace
from perfbench.tests import tiny

ROOT = spec.ROOT


def test_tiny_run_is_correct_and_loads_no_jax():
    """In a process of its own, so that no other test's imports count."""
    code = textwrap.dedent('''
        import json, sys
        sys.path.insert(0, {root!r})
        from perfbench import isolation
        from perfbench.tests import tiny
        result = tiny.run(seconds=1.0, trace=1)
        print(json.dumps({{'result': result,
                          'forbidden': isolation.found()}}))
    ''').format(root=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    result = line['result']
    assert line['forbidden'] == []
    assert result['correct'] is True and result['failed'] == 0
    assert result['attempted'] >= 1
    assert list(result)[-1] == 'checks'
    assert set(result['checks']) == {'score_noise', 'plan_gap',
                                     'distrib_noise'}
    assert result['metrics']['tail_launches']['value'] == 0.0


def test_architecture_modules_load_no_port_and_no_jax():
    """Every module under ``perfbench/archs/``, imported in a process of
    its own, loads nothing of the port and nothing of JAX."""
    code = textwrap.dedent('''
        import importlib, json, pkgutil, sys
        sys.path.insert(0, {root!r})
        import perfbench.archs
        from perfbench import isolation
        names = [m.name for m in pkgutil.iter_modules(
            perfbench.archs.__path__, 'perfbench.archs.')]
        for name in names:
            importlib.import_module(name)
        port = sorted(n for n in sys.modules
                      if n.split('.')[0] == 'visual_foresight_torch')
        print(json.dumps({{'archs': names, 'port': port,
                          'forbidden': isolation.found()}}))
    ''').format(root=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    configs = [c['name'] for c in spec.benchmark()['configs']]
    assert set(line['archs']) >= {'perfbench.archs.' + spec.module_name(c)
                                  for c in configs}
    assert line['port'] == [] and line['forbidden'] == []


def test_end_to_end_metrics_of_a_tiny_run():
    result = tiny.run(seconds=0.5)
    assert set(result['metrics']) == {'replan_ms', 'setup_s'}
    assert result['metrics']['replan_ms']['value'] > 0
    assert result['device']['platform'] == 'cpu'


def test_without_a_card_the_run_prints_nothing():
    proc = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'xz_flagship.xz_bench20', '--seed', str(tiny.SEED), '--seconds',
         '1', '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert proc.stdout == ''


def test_guard_finds_forbidden_top_level_names():
    fake = type(sys)('jax.numpy')
    sys.modules['jax.numpy'] = fake
    try:
        assert 'jax' in isolation.found()
    finally:
        del sys.modules['jax.numpy']
    # the port's name begins with the JAX package's: not a match
    assert 'visual_foresight_tpu' not in isolation.found()


def test_trace_summary():
    """Two replans, four kernels, one of them the tail; an annotation's
    device copy is not device work."""
    ev = [('perfbench.replan', False, 0, 100, 1, True),
          ('perfbench.replan', False, 100, 200, 1, True),
          ('aten::mm', False, 10, 30, 1, False),
          ('cudaStreamSynchronize', False, 60, 95, 1, False),
          ('gemm', True, 20, 40, 0, False),
          ('gemm', True, 35, 50, 0, False),
          ('void cdna_tail_tiled_kernel', True, 120, 130, 0, False),
          ('Memcpy DtoH', True, 150, 160, 0, False),
          ('perfbench.replan', True, 0, 200, 0, True)]
    s = trace.summarize(ev, 'cdna_tail')
    assert s['replans'] == 2
    assert s['window_s'] == 200e-6
    assert s['busy_s'] == 50e-6
    assert s['kernels'] == 3 and s['tail_kernels'] == 1
    assert s['tail_s'] == 10e-6
    gaps = dict(s['idle_gaps'])
    # 0-20 under aten::mm's start (perfbench.replan), 50-120 and the rest
    assert abs(sum(gaps.values()) - 150e-6) < 1e-12
    assert gaps['cudaStreamSynchronize'] == 70e-6
