#!/usr/bin/env python3
"""Time the folded CDNA tail and its backward kernel of one checkout's port
on one CUDA card.

    python3 visual_foresight_torch/tools/bench_tail.py [--root DIR]

``--root`` names the checkout whose ``visual_foresight_torch`` is timed (by
default the one holding this script), so that two trees can be timed in
turns within one run on one card; each builds its kernels into its own
``build/kernels/``.  It prints one JSON line: the card's name and power
limit, then, in bf16 at 48x64, C=3, K=5, M=10, SNA, masks blocked r=4:

- the folded tail at B=768 with P=2 (the registration path's shape) and
  P=1 (the serving shape): kernel ms;
- the backward at B=16 and 256, all four gradients: kernel ms.

Each time is one call's share of a CUDA graph of many calls cycling four
argument sets (together larger than L2), timed with CUDA events, median of
five replays.  Without a CUDA card it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys

H, W, C, K, M, R = 48, 64, 3, 5, 10, 4


def graph_ms(torch, fn, arg_sets, reps):
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('bench_tail: no CUDA device available', file=sys.stderr)
        return 1
    from visual_foresight_torch.ops import cdna_tail
    from visual_foresight_torch.ops.cdna_warp import normalize_kernels
    from visual_foresight_torch.ops.layout import space_to_depth
    if not cdna_tail.__file__.startswith(os.path.abspath(args.root)):
        raise RuntimeError('imported {}, not the port under {}'.format(
            cdna_tail.__file__, args.root))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    gen = torch.Generator(device='cuda').manual_seed(0)

    def inputs(b, p):
        rand = lambda *s: torch.rand(s, generator=gen, device='cuda')
        kernels = normalize_kernels(rand(b, K, K, M))
        masks = space_to_depth(torch.softmax(2.0 * torch.randn(
            (b, H, W, M + 2), generator=gen, device='cuda'), dim=-1), R)
        ts = (rand(b, H, W, C), rand(b, H, W, C), rand(b, H, W, p),
              rand(b, H, W, p), kernels, masks)
        return tuple(t.bfloat16().contiguous() for t in ts)

    res = {'card': card.strip().splitlines()[0],
           'root': os.path.abspath(args.root)}
    for p in (2, 1):
        sets = [inputs(768, p) for _ in range(4)]
        fwd = lambda *a: cdna_tail.fused_warp_composite(*a, mask_block=R)
        res['tail_p{}_ms'.format(p)] = graph_ms(torch, fwd, sets, 100)
        del sets
    for b in (16, 256):
        sets = []
        for _ in range(4):
            prev, first, _, _, kernels, masks = inputs(b, 0)
            grad = torch.randn((b, H, W, C), generator=gen, device='cuda')
            sets.append((grad.bfloat16(), prev, first, kernels, masks))
        bwd = lambda *a: cdna_tail.fused_warp_composite_backward(
            *a, mask_block=R)
        res['bwd_b{}_ms'.format(b)] = graph_ms(torch, bwd, sets, 50)
        del sets
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
