"""The CDNA tail's least time over its measured time (%).  The least time
of each call is the larger of its bytes over the HBM bandwidth and its f32
FLOPs over the f32 peak (``perfbench/counts/<config>.py::tail_cost``); the
measured time is that of the traced kernels whose name holds ``cdna_tail``,
and both are taken a replan."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.trace['tail_s']:
        return None
    p = ctx.traffic['designated_pixels']
    least = 0.0
    for b, n in ctx.steps:
        nbytes, flops = ctx.counts.tail_cost(ctx.cfg, b, p)
        least += n * ctx.traffic['ncam'] * max(
            nbytes / ctx.peaks['hbm_bytes'], flops / ctx.peaks['f32_flops'])
    measured = ctx.trace['tail_s'] / ctx.trace['replans']
    return 100.0 * least / measured
