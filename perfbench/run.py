"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is one configuration under one
traffic mix.  The run makes the weights, contexts, goals and draws from the
seed on the card, warms up every shape with ``warmup_replans`` replans
(set-up, timed from the start of this script), then replans in a closed
loop, one robot's controller waiting for each replan, for ``--seconds``.
With ``--trace 1`` it then traces ``trace_replans`` more replans of the same
loop with ``torch.profiler``.  It checks the window's replans against the
plain reference (``perfbench/check.py``) once the program is freed, and
prints one JSON line: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), ``correct``, the device, and the numbers
compared beside their limits under ``checks``.

It exits non-zero with no result where no CUDA card is present, where the
cell asks for more cards than there are, or where a module of JAX or of
the JAX package was loaded.  Kernel builds stay in the checkout
(``build/kernels/``); nothing else is written.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse                 # noqa: E402
import contextlib               # noqa: E402
import gc                       # noqa: E402
import json                     # noqa: E402
import os                       # noqa: E402
import sys                      # noqa: E402
import types                    # noqa: E402

import numpy as np              # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import isolation, spec  # noqa: E402

HOST_THREADS = 4
TAIL_KERNEL = 'cdna_tail'       # the tail kernel's name in the trace
REFERENCE_ROWS = 256            # the reference rolls samples in blocks


def _propagated(traffic, cfg, out):
    """The next replan's context distributions (ncam, n_ctx, H, W, P): the
    last ``n_ctx`` predicted distributions of the best plan, as
    ``PixelCostController.perform_CEM`` carries them."""
    if not traffic['predictor_propagation']:
        return None
    return np.swapaxes(out['best_distribs'][-cfg['context_frames']:], 0, 1)


def measure(parts, seed, seconds, trace, device, t_start):
    """Set-up, warm-up, the window and (with ``trace``) the traced replans
    of one run on ``device``; the program is freed on return.

    :param parts: ``spec.resolve``'s dict
    :return: (the workload, the window's records, a namespace of what the
        readers read)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import program, trace as trace_lib
    from perfbench.generator import Workload, model_steps
    from perfbench.peaks import for_device

    torch.set_num_threads(HOST_THREADS)
    cfg, traffic = parts['cfg'], parts['traffic']
    cuda = device.type == 'cuda'
    work = Workload(cfg, traffic, seed, device, parts['arch'])
    prog = program.Program(cfg, traffic, work.weights, device)

    def loop(first, carried, stop, span):
        """Replans from ``first`` (``carried``: the distributions carried
        into it) until ``stop(count, now)``; records."""
        records, i = [], first
        while True:
            x = work.inputs(i, carried)
            with span():
                out = prog.replan(x)
            now = time.perf_counter()
            out['distribs'] = x['distribs'] if \
                traffic['predictor_propagation'] else None
            records.append(out)
            carried = _propagated(traffic, cfg, out)
            i += 1
            if stop(len(records), now):
                return records, now

    plain = contextlib.nullcontext
    loop(0, None, lambda n, _: n >= traffic['warmup_replans'], plain)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = program.tail_launches()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    records, t1 = loop(0, None, lambda n, now: now - t0 >= seconds,
                       plain)
    launches = program.tail_launches() - launches0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    summary = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        span = lambda: record_function(trace_lib.SPAN)
        with profile(activities=acts) as prof:
            loop(len(records), _propagated(traffic, cfg, records[-1]),
                 lambda n, _: n >= traffic['trace_replans'], span)
        summary = trace_lib.reduce(prof, TAIL_KERNEL)
        del prof

    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(device) if cuda else 'cpu'
    stats = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, counts=parts['counts'],
        steps=model_steps(cfg, traffic), setup_s=setup_s,
        replan_ms=(t1 - t0) * 1e3 / len(records),
        trace=summary,
        tail_launches_per_replan=launches / len(records),
        peaks=for_device(name) if cuda else None, device_name=name,
        memory_peak_bytes=peak)
    return work, records, stats


def run_cell(parts, seed, seconds, trace, device, t_start):
    """One run of a cell on ``device``; returns the result dict."""
    from perfbench import check

    work, records, ctx = measure(parts, seed, seconds, trace, device,
                                 t_start)
    per_replan = check.verify(parts['arch'], parts['cfg'], parts['traffic'],
                              work, records, seed, device, REFERENCE_ROWS)
    checks, failed = check.judged(per_replan, parts['limits'])
    entries = parts['per_layer'] if trace else parts['end_to_end']
    metrics = {}
    for m in entries:
        value = spec.metric_reader(m['name']).read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    dev = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
           'kind': ctx.device_name, 'count': parts['cell']['chips'],
           'memory_peak_bytes': ctx.memory_peak_bytes}
    result = {'correct': failed == 0, 'attempted': len(records),
              'failed': failed, 'metrics': metrics, 'device': dev}
    if ctx.trace is not None:
        dev['busy_s'] = ctx.trace['busy_s']
        dev['window_s'] = ctx.trace['window_s']
        result['breakdown'] = {'device_ops': ctx.trace['device_ops'],
                               'idle_gaps': ctx.trace['idle_gaps']}
    result['checked_replans'] = [i for i, _ in per_replan]
    result['checks'] = checks       # the numbers compared come last
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bad = isolation.found()
    if bad:
        print('forbidden modules loaded at start: {}'.format(bad),
              file=sys.stderr)
        return 3
    import torch
    parts = spec.resolve(spec.benchmark(), args.workload)
    chips = parts['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('the cell needs {} CUDA card(s); found {}'.format(
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    result = run_cell(parts, args.seed, args.seconds, args.trace,
                      torch.device('cuda', 0), T_START)
    bad = isolation.found()
    if bad:
        print('forbidden modules loaded by the run: {}'.format(bad),
              file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print('check {} {!r} limit {!r}'.format(name, c['value'],
                                                c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
