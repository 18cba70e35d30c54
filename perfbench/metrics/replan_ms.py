"""The window's wall time over the replans completed in it (ms): replans
are sequential, so this is the time the robot waits on each."""


def read(ctx):
    return ctx.replan_ms
