"""The predictor's FLOPs a replan, counted from the configuration's shapes
(``perfbench/counts/<config>.py``), over the untraced window's time a
replan and the card's dense bf16 peak (%)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    p = ctx.traffic['designated_pixels']
    flops = sum(n * ctx.counts.step_flops(ctx.cfg, b, p)
                for b, n in ctx.steps)
    return 100.0 * flops / (ctx.replan_ms / 1e3) / ctx.peaks['bf16_flops']
