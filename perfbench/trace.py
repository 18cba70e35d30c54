"""Reduction of a ``torch.profiler`` trace to what the per-layer readers
read: the union of device intervals, kernels by name, and the host activity
under each gap in which the device ran nothing.

The profiler's events stay in memory; nothing is written to disk.  The
union of device intervals is the one ``chip_smoke.py::profile_replan``
takes.
"""

from collections import defaultdict

SPAN = 'perfbench.replan'        # the harness's span around each replan
NAME_CHARS = 120                 # kernel names are cut to this length


def _events(prof):
    """(name, is_device, start_us, end_us, thread, is_annotation) of every
    event."""
    from torch.autograd import DeviceType
    out = []
    results = getattr(prof.profiler, 'kineto_results', None)
    if results is not None:
        for e in results.events():
            start = e.start_ns() / 1e3
            out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                        start + e.duration_ns() / 1e3, e.start_thread_id(),
                        bool(e.is_user_annotation())))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                    e.time_range.start, e.time_range.end, e.thread,
                    e.name == SPAN))
    return out


def is_kernel(name):
    return not name.startswith(('Memcpy', 'Memset'))


def union(intervals):
    """Merged (start, end) intervals, in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def reduce(prof, tail_pattern):
    """:func:`summarize` of a finished ``torch.profiler.profile``."""
    return summarize(_events(prof), tail_pattern)


def summarize(events, tail_pattern):
    """Summary of the traced replans.

    :param events: (name, is_device, start_us, end_us, thread,
        is_annotation) of every event
    :param tail_pattern: the substring that names the tail kernel
    :return: dict with 'replans', 'window_s' (first span start to last span
        end), 'busy_s' (device intervals inside it, merged), 'kernels',
        'tail_s' (device time of kernels whose name holds
        ``tail_pattern``), 'device_ops' and 'idle_gaps' ([name, seconds],
        the ten largest); None where the trace holds no replan span or no
        device event
    """
    spans = sorted({(a, b) for name, dev, a, b, _, _ in events
                    if not dev and name == SPAN})
    # a device-side copy of an annotation spans kernels: not device work
    device = [(name, a, b) for name, dev, a, b, _, note in events
              if dev and not note and name != SPAN]
    if not spans or not device:
        return None
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    merged = union([(a, b) for _, a, b in inside])
    busy = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    kernels = tail = 0
    tail_us = 0.0
    for n, a, b in inside:
        by_name[n[:NAME_CHARS]] += b - a
        if is_kernel(n):
            kernels += 1
        if tail_pattern in n:
            tail += 1
            tail_us += b - a
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
    if merged:
        gaps = [(lo, merged[0][0])] + gaps + [(merged[-1][1], hi)]
    idle = _name_gaps(gaps, events)
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {'replans': len(spans), 'window_s': (hi - lo) / 1e6,
            'busy_s': busy / 1e6, 'kernels': kernels, 'tail_kernels': tail,
            'tail_s': tail_us / 1e6, 'device_ops': top(by_name),
            'idle_gaps': top(idle)}


def _name_gaps(gaps, events):
    """Seconds of device idle time by what the host thread that ran the
    replans was doing: the innermost host event open at each gap's
    middle."""
    span_threads = {t for name, dev, _, _, t, _ in events
                    if not dev and name == SPAN}
    host = sorted({(a, -(b - a), b, name) for name, dev, a, b, t, _ in events
                   if not dev and t in span_threads})
    out = defaultdict(float)
    stack, j = [], 0
    # one sweep: host events on one thread nest, so the open ones form a
    # stack whose top is the innermost
    for mid, length in sorted(((a + b) / 2, b - a) for a, b in gaps
                              if b > a):
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][2] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][3] if stack else 'no host event'
        out[name[:NAME_CHARS]] += length
    return out
