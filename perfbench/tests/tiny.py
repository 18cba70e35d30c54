"""A tiny cell for the CPU tests: the flagship's architecture at 16 x 24
with narrow features, a latent and propagation, in float32."""

import json
import os

import torch

from perfbench import spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def parts(**traffic):
    """``spec.resolve``'s dict for the tiny cell; ``traffic`` overrides."""
    bench = spec.benchmark()
    t = load('tiny_traffic.json')
    t.update(traffic)
    return {'cell': {'name': 'tiny', 'chips': 1},
            'cfg': load('tiny_config.json'), 'traffic': t,
            'limits': load('tiny_limits.json'),
            'arch': spec.arch('xz_flagship'),
            'counts': spec.counts('xz_flagship'),
            'end_to_end': [m for m in bench['end_to_end']
                           if 'workloads' not in m],
            'per_layer': bench['per_layer']}


def run(seconds=1.0, trace=0, **traffic):
    from perfbench import run as run_lib
    torch.manual_seed(0)
    import time
    return run_lib.run_cell(parts(**traffic), SEED, seconds, trace,
                            torch.device('cpu'), time.perf_counter())
