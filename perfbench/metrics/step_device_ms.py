"""Device busy time a model step: the traced replans' busy time (union of
device intervals) over the model steps the traffic implies (ms)."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = sum(n for _, n in ctx.steps)
    return 1e3 * ctx.trace['busy_s'] / ctx.trace['replans'] / steps
