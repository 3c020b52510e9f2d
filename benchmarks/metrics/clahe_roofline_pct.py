"""The CLAHE kernel's (K1) share of its roofline in the traced slice: the
float32 input and output of each launch the slice's requests need, moved
once over the HBM bandwidth (K1 does integer histograms and a lookup: no
products), over the device time of K1's kernels by name, whatever route
runs them."""
from peaks import HBM_BYTES_PER_S

FRAGMENTS = ("clahe_packed_kernel", "clahe_tile_lut_kernel", "clahe_tile_blend_kernel")


def read(ctx):
    sl, prog = ctx.slice, ctx.program
    if sl is None or not sl.units or not hasattr(prog, "clahe_calls"):
        return None
    calls = prog.clahe_calls(prog.request(0))
    spent = sl.seconds(sl.matching(FRAGMENTS))
    if not calls or spent <= 0:
        return None
    least = sum(2 * 4 * n * h * w for n, h, w in calls) / HBM_BYTES_PER_S
    return 100.0 * least * sl.units / spent
