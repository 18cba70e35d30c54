"""Share of a replan in which the device runs nothing: one less the traced
replans' busy time a replan over the untraced window's time a replan
(%)."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy_ms = 1e3 * ctx.trace['busy_s'] / ctx.trace['replans']
    return 100.0 * (1.0 - busy_ms / ctx.replan_ms)
