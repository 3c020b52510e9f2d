"""Seconds from the start of the run (before torch is imported) to the
first timed request or step: CUDA context, kernel build or load, weights
and inputs from the seed, warm-up."""


def read(ctx):
    return ctx.setup_s
