"""One cell's traced run with its replans' device time and idle time put
down to the program's phase spans (``spans.py``).

    python3 perfbench/phases.py --workload <cell> --seed <n> \\
        --seconds <s>

It runs ``run.py``'s ``--trace 1`` run of the cell and hands the
profiler's events to ``spans.reduce`` beside ``trace.reduce``, and prints
one JSON line: ``run.py``'s result with 'spans' (the reduction: totals and
a row for each span path) and 'layers' (``spans.layers``: the per-layer
numbers in ms a replan), both None where the program opens no spans, and
'traced_replan_ms' and 'untraced_replan_ms' (the traced window and the
untraced window a replan).  Like ``run.py`` it needs a CUDA card.
"""

import argparse
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import run, spans, spec, trace  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    parts = spec.resolve(spec.benchmark(), args.workload)
    found = {}
    reduce = trace.reduce

    def both(prof, tail_pattern):
        found['spans'] = spans.reduce(prof)
        return reduce(prof, tail_pattern)

    with mock.patch.object(trace, 'reduce', both):
        result = run.run_cell(parts, args.seed, args.seconds, 1,
                              torch.device('cuda', 0), run.T_START)
    summary = found.get('spans')
    result['spans'] = summary
    result['layers'] = spans.layers(summary) if summary else None
    dev, metrics = result['device'], result['metrics']
    if 'window_s' in dev and 'planner_host_ms' in metrics:
        replans = parts['traffic']['trace_replans']
        result['traced_replan_ms'] = 1e3 * dev['window_s'] / replans
        result['untraced_replan_ms'] = metrics['planner_host_ms']['value'] \
            + 1e3 * dev['busy_s'] / replans
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
