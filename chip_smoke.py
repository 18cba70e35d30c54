#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

1. prints the torch/CUDA versions and the card's name and power limit;
2. builds ``visual_foresight_torch/csrc/cdna_tail.cu`` with nvcc for sm_90a
   and prints ptxas's register, shared-memory and spill report;
3. holds the CDNA tail kernel against its plain PyTorch version at the
   serving shapes (B=200, 48x64, C=3, P=1, K=5, M=10, SNA) in bf16 and f32,
   and with SNA off and with P=0 at a small batch;
4. drives the serving replan: ``TorchPredictor`` at the xz_flagship config
   (seeded weights, bf16) and ``FusedCEMPlanner`` with 200 samples x 15
   steps x 3 iterations, for a few replans with fresh contexts; checks the
   outputs, that the kernel ran 46 times per replan, and that one replan
   with the plain tail gives the same elites and scores;
5. times the replan, the kernel and its plain version, beside the bound.

It prints one JSON line describing the kernels, then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero; without a CUDA card it exits non-zero before printing a result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

H, W, C, P, K, NUM_MASKS = 48, 64, 3, 1, 5, 10
M, ITERS, NACT, REPEAT, N_CTX = 200, 3, 5, 3, 2
T = NACT * REPEAT
LAUNCHES_PER_REPLAN = 1 + ITERS * T           # encode step + rollouts
# bf16: one ulp near 1.0 is 7.8e-3; both sides accumulate in f32 and round
# once, so they differ by at most one ulp of outputs below 2
TAIL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# planner scores through 15 bf16 steps, relative to the largest score
SCORE_RTOL = 2e-2
N_WARM, N_TIMED = 2, 10


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def tail_inputs(gen, b, dtype, sna=True, p=P):
    """Realistic tail inputs: frames in [0, 1], normalized kernels,
    softmax masks."""
    from visual_foresight_torch.ops.cdna_warp import normalize_kernels
    dev = 'cuda'
    offset = 2 if sna else 1
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    kernels = normalize_kernels(rand(b, K, K, NUM_MASKS))
    masks = torch.softmax(2.0 * torch.randn(
        (b, H, W, NUM_MASKS + offset), generator=gen, device=dev), dim=-1)
    ts = (rand(b, H, W, C), rand(b, H, W, C), rand(b, H, W, p),
          rand(b, H, W, p), kernels, masks)
    return tuple(t.to(dtype).contiguous() for t in ts)


def check_tail(gen, b, dtype, sna=True, p=P):
    from visual_foresight_torch.ops.cdna_tail import (
        fused_warp_composite, fused_warp_composite_reference)
    args = tail_inputs(gen, b, dtype, sna, p)
    got = fused_warp_composite(*args, sna=sna)
    want = fused_warp_composite_reference(*args, sna=sna)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    tol = TAIL_TOL[dtype]
    print('tail kernel vs plain: B={} {} sna={} P={}: max_abs_err={:.3e} '
          '(tol {:.0e})'.format(b, str(dtype).split('.')[-1], sna, p, err,
                                tol))
    if not err <= tol:
        raise AssertionError('tail kernel disagrees with its plain version')
    return err


def graph_ms(fn, arg_sets, reps):
    """Device time of one ``fn`` call: ``reps`` calls cycling through
    ``arg_sets`` (together larger than L2) captured in one CUDA graph,
    timed with CUDA events, median of 5 replays."""
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
    return float(np.median(times))


def tail_bound(args, outs, sna):
    """Least time for the tail on an H100 SXM: every input read once and
    every output written once, against the f32 arithmetic the in-bounds
    taps need."""
    b, h, w, c = args[0].shape
    p = args[2].shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in args + outs)
    pad = K // 2
    rows = K * h - 2 * sum(range(1, pad + 1))   # in-bounds (row, tap-row)
    cols = K * w - 2 * sum(range(1, pad + 1))
    taps = b * rows * cols                      # in-bounds (pixel, tap)
    fma = taps * (NUM_MASKS + c + p) + b * h * w * (c + p) * (2 if sna else 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * fma / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def profile_replan(run):
    """Device time by kernel over one replan (``torch.profiler``) and the
    device's busy share of that replan's wall time, printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        print('profile: no device events recorded (breakdown not measured)')
        return
    busy, end = 0.0, None
    for a, b in sorted(spans):      # union of device intervals
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    print('profile of one replan (profiler on): wall {:.3f} ms, {} device '
          'kernels, device busy {:.3f} ms = {:.1%} of wall'.format(
              wall_us / 1e3, len(spans), busy / 1e3, busy / wall_us))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        print('  {:9.3f} ms {:5d}x  {}'.format(us / 1e3, n, name[:90]))


def compare_replans(out_k, out_p):
    """Kernel tail vs plain tail, same plans: scores within SCORE_RTOL of
    the largest score and the same elites; where elites differ, each
    swapped sample must score within that tolerance of the K-th elite, and
    later iterations (sampled from a different refit) are not compared."""
    kk = out_k['best_scores'].shape[0]
    for itr in range(ITERS):
        sk = out_k['scores_per_itr'][itr].float()
        sp = out_p['scores_per_itr'][itr].float()
        tol = SCORE_RTOL * float(sp.abs().max())
        err = float((sk - sp).abs().max())
        ek = set(torch.topk(-sk, kk).indices.tolist())
        ep = set(torch.topk(-sp, kk).indices.tolist())
        print('replan kernel vs plain tail, iteration {}: max score diff '
              '{:.3e} (tol {:.3e}), elites equal: {}'.format(
                  itr, err, tol, ek == ep))
        if not err <= tol:
            raise AssertionError('replan scores disagree with the plain tail')
        if ek != ep:
            kth = float(torch.topk(-sp, kk).values[-1].neg())
            gap = max(abs(float(sp[i]) - kth) for i in ek ^ ep)
            print('elites differ at the boundary: gap {:.3e}'.format(gap))
            if not gap <= tol:
                raise AssertionError('elite sets disagree beyond a tie')
            return


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    from visual_foresight_torch.models import cdna as cdna_model
    from visual_foresight_torch.ops import _build
    from visual_foresight_torch.ops.cdna_tail import (
        SOURCE, fused_warp_composite, fused_warp_composite_reference)
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.costs import distance_grid
    from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                          initial_sigma,
                                                          make_action_spec)
    from visual_foresight_torch.prediction.predictor import TorchPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print('python {} torch {} cuda {}'.format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    print('device: {} (count {})'.format(kind, torch.cuda.device_count()))
    print(card)

    # -- build ---------------------------------------------------------------
    t0 = time.time()
    _, report = _build.build(SOURCE)
    print('built {} in {:.1f} s'.format(SOURCE, time.time() - t0))
    for line in report.splitlines():
        if any(k in line for k in ('entry function', 'Used', 'spill')):
            print('  ' + line.strip())

    # -- kernel against its plain version ------------------------------------
    gen = torch.Generator(device='cuda').manual_seed(0)
    err_bf16 = check_tail(gen, M, torch.bfloat16)
    check_tail(gen, M, torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        check_tail(gen, 8, dtype, sna=False)
        check_tail(gen, 8, dtype, p=0)
        check_tail(gen, 8, dtype, sna=False, p=0)

    # -- main path: the serving replan ----------------------------------------
    predictor = TorchPredictor(
        os.path.join(REPO, 'benchmarks', 'models', 'xz_flagship'), {
            'designated_pixel_count': P, 'run_batch_size': M,
            'sequence_length': T + N_CTX, 'context_frames': N_CTX,
            'ncam': 1, 'img_dims': (H, W), 'adim': 3, 'sdim': 3,
            'dtype': 'bfloat16', 'std_factor': 4,
            'enc_features': (128, 256, 256), 'separable_lstm': True,
            'lstm_kernel': 3}, device='cuda')
    predictor.restore()
    n_params = sum(p.numel() for p in predictor.models[0].parameters())
    print('predictor: restored={} params={}'.format(predictor.restored,
                                                     n_params))
    spec = make_action_spec({
        'initial_std': 0.05, 'initial_std_lift': 0.15,
        'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
        'action_order': ['x', 'z', 'grasp'], 'nactions': NACT,
        'repeat': REPEAT}, 3)
    planner = FusedCEMPlanner(spec, M, iterations=ITERS, k_elite=10,
                              finalweight=10.0, action_bound=True,
                              n_vis=10, device='cuda')
    rng = np.random.RandomState(0)
    distribs = np.zeros((1, N_CTX, H, W, P), np.float32)
    distribs[:, :, 24, 32, 0] = 1.0
    ctx_actions = np.zeros((N_CTX - 1, 3), np.float32)
    grids = distance_grid([[[10.0, 50.0]]], H, W, device='cuda')
    mean0 = initial_mean(spec, device='cuda')
    sigma0 = initial_sigma(spec, device='cuda')
    contexts = [(rng.rand(1, N_CTX, H, W, 3).astype(np.float32),
                 (rng.randn(N_CTX, 3) * 0.05).astype(np.float32))
                for _ in range(N_WARM + N_TIMED)]
    plan_gen = torch.Generator(device='cuda').manual_seed(1)

    def replan(images, states, **noise):
        return planner.replan(predictor.models, images, states, distribs,
                              ctx_actions, grids, mean0, sigma0, **noise)

    fused_warp_composite.launches = 0
    latencies, outs = [], []
    for i, (images, states) in enumerate(contexts):
        t0 = time.perf_counter()
        out = replan(images, states, generator=plan_gen)
        torch.cuda.synchronize()
        if i >= N_WARM:
            latencies.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = fused_warp_composite.launches
    want = LAUNCHES_PER_REPLAN * len(contexts)
    print('main path: {} replans, {} tail kernel launches (expected {})'
          .format(len(contexts), launches, want))
    if launches != want:
        raise AssertionError('the main path did not run the tail kernel '
                             '{} times per replan'.format(
                                 LAUNCHES_PER_REPLAN))
    for out in outs:
        shapes = {'best_actions': (10, T, 3), 'best_scores': (10,),
                  'scores_per_itr': (ITERS, M)}
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or \
                    not bool(torch.isfinite(out[key]).all()):
                raise AssertionError('replan output {} is {} or not finite'
                                     .format(key, tuple(out[key].shape)))
        vis = out['vis']['gen_images']
        if tuple(vis.shape) != (10, T, 1, H, W, 3) or \
                not bool(torch.isfinite(vis).all()):
            raise AssertionError('elite videos malformed')
    print('replan outputs finite; best score {:.4f}'.format(
        float(outs[-1]['best_scores'][0])))

    # -- the same replan with the plain tail on the card ----------------------
    noise = torch.randn((ITERS, M, NACT * 3), generator=plan_gen,
                        device='cuda')
    images, states = contexts[0]
    out_k = replan(images, states, noise=noise)
    cdna_model.fused_warp_composite = fused_warp_composite_reference
    try:
        out_p = replan(images, states, noise=noise)
    finally:
        cdna_model.fused_warp_composite = fused_warp_composite
    torch.cuda.synchronize()
    compare_replans(out_k, out_p)

    # -- times ----------------------------------------------------------------
    sets = [tail_inputs(gen, M, torch.bfloat16) for _ in range(4)]
    kernel_ms = graph_ms(lambda *a: fused_warp_composite(*a, sna=True),
                         sets, reps=100)
    plain_ms = graph_ms(
        lambda *a: fused_warp_composite_reference(*a, sna=True), sets,
        reps=10)
    bound_ms, bound_by = tail_bound(sets[0], fused_warp_composite_reference(
        *sets[0], sna=True), sna=True)
    p50 = float(np.percentile(latencies, 50))
    print('replan_p50_ms={:.3f} (200 samples x 15 steps x 48x64 x 3 iters, '
          'bf16, host clock, {} replans) [{}]'.format(p50, N_TIMED, card))
    print('cdna_tail_kernel_ms={:.5f} (B=200 bf16, CUDA graph, CUDA '
          'events) [{}]'.format(kernel_ms, card))
    print('cdna_tail_plain_ms={:.5f} (same inputs, CUDA graph, CUDA '
          'events) [{}]'.format(plain_ms, card))
    print('cdna_tail_bound_ms={:.5f} (by {}; H100 SXM 3.35 TB/s, 67 TFLOP/s '
          'f32) [{}]'.format(bound_ms, bound_by, card))

    profile_replan(lambda: replan(*contexts[0], generator=plan_gen))

    print(json.dumps({'kernels': [{
        'name': 'cdna_tail', 'route': 'cuda',
        'source': 'visual_foresight_torch/csrc/cdna_tail.cu',
        'replaces': 'visual_foresight_tpu/ops/pallas_cdna.py:71',
        'launches': launches, 'max_abs_err': err_bf16, 'ms': kernel_ms,
        'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
