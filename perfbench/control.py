"""Readings behind the limits of ``correct``, for one cell, many seeds in
one process (the benchmark's own runs never run this):

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--control] [--fault static_step] [--dtype float32] \\
        [--out file.jsonl]

For each seed it runs the cell's set-up and a short window of the program,
then checks the window's replans as a run does and prints the program's
numbers (the lower readings).  With ``--control`` it also puts the
reference one precision below the program's (the predictor's products in
float8 e4m3 under a per-tensor scale, below the configuration's bfloat16;
the planner's float32 products in TF32) in the program's place, along the
same elites, and prints its numbers (the upper readings).  With
``--fault`` the program runs with a fault of ``perfbench/faults.py``
planted.  With ``--dtype float32`` the program serves the predictor in
float32 (TF32 off), a second witness beside the reference.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import spec  # noqa: E402


def readings(traffic, got, ref, served):
    """The numbers compared and, beside them, the raw gaps: the widest and
    the root mean square score gap (``score_gap``, ``score_rms``) and, under
    propagation, the widest gap of the carried distributions over their
    peak (``distrib_gap``)."""
    import numpy as np
    from perfbench import check
    out = check.gaps(traffic, got, ref, served)
    gap = got['scores'] - ref['scores']
    out['score_gap'] = float(np.max(np.abs(gap)))
    out['score_rms'] = float(np.sqrt(np.mean(np.square(gap))))
    if traffic['predictor_propagation']:
        out['distrib_gap'] = float(np.max(np.abs(
            got['best_distribs'] - ref['best_distribs']))) / \
            float(np.max(np.abs(ref['best_distribs'])))
    return out


def read_seed(parts, seed, seconds, device, with_control):
    """One seed's readings: the program's numbers and, ``with_control``, the
    control's (the reference one precision lower, in the program's place
    along the same elites)."""
    from perfbench import check, run
    from perfbench.reference.planner import judge, make_reference
    cfg, traffic = parts['cfg'], parts['traffic']
    t = time.perf_counter()
    work, records, stats = run.measure(parts, seed, seconds, 0, device, t)
    chosen = check.picks(seed, len(records), traffic['check_replans'])
    t_check = time.perf_counter()
    both = check.references(parts['arch'], cfg, traffic, work, records,
                            chosen, device, run.REFERENCE_ROWS)
    line = {'seed': seed, 'replans': len(records),
            'replan_ms': stats.replan_ms, 'setup_s': stats.setup_s,
            'check_s': time.perf_counter() - t_check,
            'program': {i: readings(traffic, records[i], r, s)
                        for i, (r, s) in zip(chosen, both)}}
    if with_control:
        low = make_reference(parts['arch'], cfg, work.weights, traffic,
                             device, precision='lower')
        got = {}
        for i in chosen:
            got[i] = judge(low, traffic, check.replan_inputs(work, records, i),
                           records[i]['scores'], block=run.REFERENCE_ROWS,
                           keep_best=traffic['predictor_propagation'])
            got[i]['best_actions'] = got[i]['best_plans']
        line['control'] = {i: readings(traffic, got[i], r, s)
                           for i, (r, s) in zip(chosen, both)}
    line['seconds'] = time.perf_counter() - t
    return line


def main(argv=None):
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--control', action='store_true')
    parser.add_argument('--fault', default=None)
    parser.add_argument('--out', default=None)
    parser.add_argument('--dtype', default=None,
                        help='serve the predictor in this dtype instead of '
                        "the configuration's (a second witness)")
    args = parser.parse_args(argv)
    parts = spec.resolve(spec.benchmark(), args.workload)
    if args.dtype:
        parts['cfg']['dtype'] = args.dtype
    device = torch.device('cuda', 0) if torch.cuda.is_available() else \
        torch.device('cpu')
    seeds = [int(s) for s in args.seeds.split(',')]
    for seed in seeds:
        if args.fault:
            from perfbench.faults import planted
            with planted(args.fault):
                line = read_seed(parts, seed, args.seconds, device, False)
            line['fault'] = args.fault
        elif args.dtype == 'float32':
            # the program's float32 path as a witness runs in float32
            from perfbench.reference.planner import exact_f32
            with exact_f32():
                line = read_seed(parts, seed, args.seconds, device,
                                 args.control)
        else:
            line = read_seed(parts, seed, args.seconds, device, args.control)
        line['workload'] = args.workload
        line['dtype'] = parts['cfg']['dtype']
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
