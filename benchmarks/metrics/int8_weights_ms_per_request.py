"""Wall time of ``ops/quant``'s ``int8/weights`` spans (a layer's weight
quantised on its first use in an ``int8_serving`` context) in ms per
request of the slice."""
import program_spans


def read(ctx):
    return program_spans.per_unit(ctx.slice, ("int8/weights",), "units")
