"""Wall time of ``train/optimizer`` spans (Adam's step, the EMA update, the
step count) in ms per training step of the slice."""
import program_spans


def read(ctx):
    return program_spans.per_unit(ctx.slice, ("train/optimizer",), "units")
