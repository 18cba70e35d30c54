"""The reduction of a trace to the program's phase spans
(``perfbench/spans.py``) on a synthetic event list, beside
``trace.summarize`` on the same list, and on a tiny CPU run."""

from unittest import mock

import pytest

from perfbench import spans, trace
from perfbench.tests import tiny

E = spans.Event


def host(name, a, b, corr=0, runtime=False, note=False):
    return E(name, False, a, b, 1, note, corr, 0, runtime)


def dev(name, a, b, corr, note=False):
    return E(name, True, a, b, 0, note, corr, 7, False)


# one replan of the harness (0-100 us): a rollout of two steps and a score;
# corr 99 has no launching call; the program's annotations are copied onto
# the device timeline
EVENTS = [
    host('perfbench.replan', 0, 100, note=True),
    host('vf.replan', 5, 90, note=True),
    host('vf.rollout', 10, 60, note=True),
    host('vf.step', 12, 30, note=True),
    host('vf.step', 30, 55, note=True),
    host('vf.score', 60, 80, note=True),
    host('aten::mm', 13, 14),
    host('cudaLaunchKernel', 13, 14, corr=1, runtime=True),
    host('cudaLaunchKernel', 31, 32, corr=2, runtime=True),
    host('cudaLaunchKernel', 62, 63, corr=3, runtime=True),
    host('cudaMemcpyAsync', 92, 93, corr=4, runtime=True),
    dev('gemm', 20, 30, 1),
    dev('add', 35, 50, 2),
    dev('mul', 50, 52, 99),
    dev('sum', 65, 70, 3),
    dev('Memcpy DtoH (Device -> Pinned)', 93, 95, 4),
    dev('perfbench.replan', 0, 100, 0, note=True),
    dev('vf.replan', 5, 90, 0, note=True),
    dev('vf.step', 20, 52, 0, note=True),
]
ROLL = 'vf.replan/vf.rollout'
STEP = ROLL + '/vf.step'


def test_launches_idle_and_self_time_by_span():
    s = spans.summarize(EVENTS)
    ph = s['phases']
    assert s['replans'] == 1 and s['unmatched'] == 1 and s['kernels'] == 4
    assert s['window_s'] == pytest.approx(100e-6)
    assert s['busy_s'] == pytest.approx(34e-6)
    assert s['idle_s'] == pytest.approx(66e-6)
    # matched by correlation id, and the unmatched kernel on its stream
    # after the last matched one
    assert ph[STEP]['busy_s'] == pytest.approx(27e-6)
    assert ph[STEP]['kernels'] == 3 and ph[STEP]['count'] == 2
    assert ph['vf.replan/vf.score']['busy_s'] == pytest.approx(5e-6)
    assert ph['harness']['copies'] == 1 and ph['harness']['kernels'] == 0
    # idle cut at the span boundaries; the harness outside the replan
    idle = {row: r['idle_s'] * 1e6 for row, r in ph.items()}
    assert idle == pytest.approx({'harness': 13, 'vf.replan': 15, ROLL: 7,
                                  STEP: 16, 'vf.replan/vf.score': 15})
    assert sum(idle.values()) == pytest.approx(66)
    # self time: duration less the direct children's
    self_us = {row: r['self_s'] * 1e6 for row, r in ph.items()
               if row != 'harness'}
    assert self_us == pytest.approx({'vf.replan': 15, ROLL: 7, STEP: 43,
                                     'vf.replan/vf.score': 20})
    lay = spans.layers(s)
    assert lay['rollout_step_ms'] == pytest.approx(0.0135)
    assert lay['predictor_idle_ms'] == pytest.approx(0.023)
    assert lay['planner_busy_ms'] == pytest.approx(0.005)
    assert lay['planner_idle_ms'] == pytest.approx(0.030)
    assert lay['harness_idle_ms'] == pytest.approx(0.013)
    assert lay['idle_ms'] == pytest.approx(0.066)
    assert lay['unmatched_share'] == pytest.approx(25.0)


def test_a_program_without_spans_gives_none():
    plain = [e for e in EVENTS if not e.name.startswith('vf.')]
    assert spans.summarize(plain) is None
    assert spans.summarize([e for e in EVENTS if not e.device]) is None


def test_trace_summary_is_the_same_without_the_annotations():
    """The program's annotations, on the host and copied onto the device,
    change no device number of ``trace.summarize``; its idle gaps keep
    their total and are named by the innermost span instead."""
    six = lambda evs: [(e.name, e.device, e.start, e.end, e.thread, e.note)
                       for e in evs]
    got = trace.summarize(six(EVENTS), 'tail')
    want = trace.summarize(six(e for e in EVENTS
                               if not e.name.startswith('vf.')), 'tail')
    total = lambda s: sum(v for _, v in s['idle_gaps'])
    assert total(got) == pytest.approx(total(want))
    assert {k: v for k, v in got.items() if k != 'idle_gaps'} == \
        {k: v for k, v in want.items() if k != 'idle_gaps'}
    assert got['kernels'] == 4
    assert got['idle_gaps'][0][0].startswith('vf.')


def test_a_tiny_cpu_run_gives_no_spans_and_does_not_raise():
    found = {}
    reduce = trace.reduce

    def both(prof, tail_pattern):
        found['spans'] = spans.reduce(prof)
        return reduce(prof, tail_pattern)

    with mock.patch.object(trace, 'reduce', both):
        result = tiny.run(seconds=0.5, trace=1)
    assert result['correct'] is True
    assert 'spans' in found and found['spans'] is None
