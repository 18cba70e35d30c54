"""Reduction of a ``torch.profiler`` trace to the program's phase spans.

The program opens ``vf.*`` spans inside its replan
(``visual_foresight_torch/utils/profiling.py``): ``vf.replan`` around the
whole of it and, inside, the inputs, the encode, the sampling, each
rollout and its model steps, each score, the selection, the refit and the
videos.  This module puts the traced device time down to them:

- **launches:** each device event (kernel, copy, fill) goes to the
  innermost ``vf.*`` span open on the replan thread when the runtime call
  that launched it began, found by correlation id; an event with no such
  call goes to the span of the nearest earlier matched event on its stream
  and is counted as unmatched;
- **idle:** each gap in which the device runs nothing, inside the traced
  window as ``trace.py`` takes it, is cut at the spans' boundaries and
  each piece goes to the innermost span open over it;
- what falls where no ``vf.replan`` is open goes to ``harness``.

A row of the result is a span's path (``vf.replan/vf.rollout/vf.step``).
The span names are the benchmark's own strings, so a program without the
spans gives None and nothing raises.
"""

import bisect
from collections import defaultdict, namedtuple

from perfbench import trace as trace_lib

PREFIX = 'vf.'
REPLAN = 'vf.replan'
ENCODE, ROLLOUT, STEP = 'vf.encode', 'vf.rollout', 'vf.step'
PREDICTOR = (ENCODE, ROLLOUT, STEP)     # the predictor's spans
HARNESS = 'harness'

# times in microseconds; ``corr`` is the correlation id, ``stream`` the
# device stream, ``runtime`` true for a host call that launches work
Event = namedtuple('Event', 'name device start end thread note corr stream '
                            'runtime')


def events(prof):
    """The :class:`Event` of each of a finished profiler's events."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA, start,
                         start + e.duration_ns() / 1e3, e.start_thread_id(),
                         bool(e.is_user_annotation()), e.correlation_id(),
                         e.device_resource_id(), _is_runtime(e.name())))
    return out


def _is_runtime(name):
    """A call of the CUDA API (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync``): the host events whose correlation ids are those
    of the device work they launch (an aten op's id is of another
    count)."""
    return name.startswith('cuda') or (name.startswith('cu') and
                                       name[2:3].isupper())


def reduce(prof):
    """:func:`summarize` of a finished ``torch.profiler.profile``."""
    return summarize(events(prof))


def _segments(spans, lo, hi):
    """[(start, end, path)] covering ``lo``..``hi``: the path of the
    innermost span open over each piece, None where none is.  ``spans``
    are (start, end, name) of one thread, which nest."""
    points = sorted({lo, hi} | {t for a, b, _ in spans for t in (a, b)
                                if lo < t < hi})
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        while j < len(ordered) and ordered[j][0] <= mid:
            while stack and stack[-1][0] <= ordered[j][0]:
                stack.pop()
            parent = stack[-1][1] if stack else ()
            stack.append((ordered[j][1], parent + (ordered[j][2],)))
            j += 1
        while stack and stack[-1][0] <= mid:
            stack.pop()
        path = stack[-1][1] if stack else None
        if out and out[-1][2] == path and out[-1][1] == a:
            out[-1] = (out[-1][0], b, path)
        else:
            out.append((a, b, path))
    return out


def _row(path):
    """The row a path goes to: ``harness`` outside every replan."""
    if not path or path[0] != REPLAN:
        return HARNESS
    return '/'.join(path)


def summarize(evs):
    """Device time and idle time of the traced replans by phase span.

    :param evs: :class:`Event` of every event
    :return: dict with 'replans', 'window_s', 'busy_s', 'idle_s',
        'kernels', 'unmatched' (totals over the traced replans, as
        ``trace.py`` takes them) and 'phases': for each row, 'count' (spans
        of that path), 'busy_s' (device time launched under it), 'kernels',
        'copies', 'fills', 'idle_s' and 'self_s' (host time under the span
        and under none of its child spans); None where the trace holds no
        ``vf.replan`` span or no device event
    """
    replans = [e for e in evs if not e.device and e.name == REPLAN]
    device = [e for e in evs if e.device and not e.note and
              e.name != trace_lib.SPAN]
    if not replans or not device:
        return None
    harness = [e for e in evs if not e.device and e.name == trace_lib.SPAN]
    window = harness or replans
    lo, hi = min(e.start for e in window), max(e.end for e in window)
    threads = {e.thread for e in replans}
    spans = [(e.start, e.end, e.name) for e in evs
             if not e.device and e.thread in threads and
             e.name.startswith(PREFIX)]
    segs = _segments(spans, lo, hi)
    starts = [a for a, _, _ in segs]

    def path_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if 0 <= i and t < segs[i][1] else None

    rows = defaultdict(lambda: dict.fromkeys(
        ('count', 'busy_s', 'kernels', 'copies', 'fills', 'idle_s',
         'self_s'), 0))
    # each span's count and host self time
    for path, a, b, children in _tree(spans):
        r = rows[_row(path)]
        r['count'] += 1
        r['self_s'] += (b - a - children) / 1e6

    # launches
    launched = {e.corr: e.start for e in evs if not e.device and e.runtime}
    inside = sorted((e for e in device if e.end > lo and e.start < hi),
                    key=lambda e: e.start)
    last_on = {}
    unmatched = kernels = 0
    busy = []
    for e in inside:
        if e.corr in launched:
            row = _row(path_at(launched[e.corr]))
            last_on[e.stream] = row
        else:
            row = last_on.get(e.stream, HARNESS)
            unmatched += 1
        a, b = max(e.start, lo), min(e.end, hi)
        busy.append((a, b))
        r = rows[row]
        r['busy_s'] += (b - a) / 1e6
        if e.name.startswith('Memcpy'):
            r['copies'] += 1
        elif e.name.startswith('Memset'):
            r['fills'] += 1
        else:
            r['kernels'] += 1
            kernels += 1

    # idle: the window less the union of device intervals
    merged = trace_lib.union(busy)
    edges = [lo] + [t for ab in merged for t in ab] + [hi]
    idle = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while a < b and i < len(segs):
            _, s1, path = segs[i]
            piece = min(b, s1) - a
            rows[_row(path)]['idle_s'] += piece / 1e6
            idle += piece
            a, i = a + piece, i + 1
    return {'replans': len(replans), 'window_s': (hi - lo) / 1e6,
            'busy_s': sum(b - a for a, b in merged) / 1e6,
            'idle_s': idle / 1e6, 'kernels': kernels,
            'unmatched': unmatched, 'phases': dict(rows)}


def _tree(spans):
    """(path, start, end, time covered by direct children) of each span;
    ``spans`` nest."""
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack = [], []     # stack: indices into out

    def close(until):
        while stack and out[stack[-1]][2] <= until:
            stack.pop()

    for a, b, name in ordered:
        close(a)
        parent = out[stack[-1]][0] if stack else ()
        if stack:
            out[stack[-1]][3] += b - a
        out.append([parent + (name,), a, b, 0.0])
        stack.append(len(out) - 1)
    return [tuple(s) for s in out]


def layers(summary):
    """The per-layer numbers the spans give, in ms a replan:
    'rollout_step_ms' (device time launched under the rollouts' model
    steps over those steps), 'predictor_idle_ms' (idle under the encode,
    a rollout or a step), 'planner_busy_ms' and 'planner_idle_ms' (under
    ``vf.replan`` and its other spans), 'harness_idle_ms' (where no replan
    is open), and the checks: 'idle_ms' (the window's idle time) and
    'unmatched_share' (unmatched device events over kernels, %)."""
    n = summary['replans']
    ms = lambda s: 1e3 * s / n
    out = dict.fromkeys(('predictor_idle_ms', 'planner_busy_ms',
                         'planner_idle_ms', 'harness_idle_ms'), 0.0)
    step_busy = steps = 0
    for row, r in summary['phases'].items():
        path = row.split('/')
        if row == HARNESS:
            out['harness_idle_ms'] += ms(r['idle_s'])
        elif path[-1] in PREDICTOR:
            out['predictor_idle_ms'] += ms(r['idle_s'])
        else:
            out['planner_busy_ms'] += ms(r['busy_s'])
            out['planner_idle_ms'] += ms(r['idle_s'])
        if path[-1] == STEP and ROLLOUT in path:
            step_busy += r['busy_s']
            steps += r['count']
    out['rollout_step_ms'] = 1e3 * step_busy / steps if steps else None
    out['idle_ms'] = ms(summary['idle_s'])
    out['unmatched_share'] = 100.0 * summary['unmatched'] / max(
        summary['kernels'], 1)
    return out
