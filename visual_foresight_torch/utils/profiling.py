"""Replan-phase profiling hooks.

The port's counterpart of ``visual_foresight_tpu/utils/profiling.py``.
``span`` marks a phase in a ``torch.profiler`` trace with
``torch.profiler.record_function`` while the profiler records, and costs
one check of the profiler's state otherwise; it reads no clock, so a
span's only timestamps are the profiler's, on the clock of its device
events.  The replan path opens the spans named below (``planners/cem.py``,
``models/cdna.py``).  ``PhaseTimer`` accumulates the host's wall time of
named phases (with the same ``report`` keys as the JAX timer) and marks
each phase with ``span``, where JAX uses ``jax.profiler.TraceAnnotation``.
``device_trace`` records a ``torch.profiler`` trace (the CUDA activity too
where a card is present) and writes it as a chrome trace into a directory,
where JAX's writes a ``jax.profiler`` trace.
"""

import contextlib
import json
import time
from collections import defaultdict

import torch

# the replan's spans, outermost first; ``FusedCEMPlanner.replan`` passes
# its replan number as the args of its own spans
REPLAN = 'vf.replan'      # one replan
INPUTS = 'vf.inputs'      # host-to-device copies of the inputs and draws
ENCODE = 'vf.encode'      # the batch-1 context encode and carry broadcast
SAMPLE = 'vf.sample'      # drawing one iteration's plans
ROLLOUT = 'vf.rollout'    # one rollout, its final stacks and casts too
STEP = 'vf.step'          # one model step (``models/cdna.py``)
SCORE = 'vf.score'        # the cost of one rollout
SELECT = 'vf.select'      # elite selection and gather
REFIT = 'vf.refit'        # the refit of the sampling distribution
VIS = 'vf.vis'            # the returned videos

_OFF = contextlib.nullcontext()


def span(name, args=None):
    """``torch.profiler.record_function(name, args)`` while the profiler
    records; else one shared context that does nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, args)


class PhaseTimer:
    """Accumulating wall-clock phase timer with JSON reporting."""

    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._totals[name] += dt
                self._counts[name] += 1

    def report(self):
        out = {}
        for name, total in sorted(self._totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self._counts[name]
            out[name] = {'total_s': round(total, 4), 'count': n,
                         'mean_ms': round(total / n * 1e3, 3)}
        return out

    def log(self, logger=None):
        line = json.dumps(self.report())
        if logger is not None:
            logger.log(line)
        else:
            print(line)


@contextlib.contextmanager
def device_trace(log_dir):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where a card is present) and write it into ``log_dir`` as
    a chrome trace (``<host>_<pid>.<time>.pt.trace.json``, which
    TensorBoard's profiler plugin and ``chrome://tracing`` read).  Yields
    the profiler, whose ``events()`` hold the same records."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
