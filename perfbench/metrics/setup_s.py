"""Start of the run script to the first timed replan (s): imports, CUDA
start-up, the kernel library's build or load, weights and inputs, and the
warm-up replans."""


def read(ctx):
    return ctx.setup_s
