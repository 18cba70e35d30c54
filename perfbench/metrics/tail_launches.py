"""Launches of the CDNA tail kernel a replan over the window, read from the
program's counter ``fused_warp_composite.launches``."""


def read(ctx):
    return ctx.tail_launches_per_replan
