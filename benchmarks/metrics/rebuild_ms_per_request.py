"""Wall time of the lip-sync entry's ``lipsync/build`` spans (the generator
built, its state dict loaded and placed, once a request) in ms per request
of the slice."""
import program_spans


def read(ctx):
    return program_spans.per_unit(ctx.slice, ("lipsync/build",), "units")
