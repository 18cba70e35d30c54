"""Device kernels a traced replan (copies and fills excluded)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace['kernels'] / ctx.trace['replans']
