"""Model FLOPs (int8: operations) of the window's completed work, counted
by the benchmark from the configuration's shapes, over the window's
seconds, over the card's dense peak in the cell's compute precision
(``peaks.PEAK_OPS``), in %."""
from peaks import PEAK_OPS


def read(ctx):
    w, prog = ctx.window, ctx.program
    if not w.requests or w.seconds <= 0:
        return None
    per_unit = prog.model_flops(prog.request(0))
    return 100.0 * per_unit * w.requests / w.seconds / PEAK_OPS[prog.precision]
