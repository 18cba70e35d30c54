"""Host time of a replan outside the device: the untraced window's wall
time a replan less the traced replans' device busy time a replan (ms)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.replan_ms - 1e3 * ctx.trace['busy_s'] / ctx.trace['replans']
