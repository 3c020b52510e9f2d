"""K6's share of its roofline in the traced slice: the least time of the
int8 products the slice's requests need (each product: the larger of
2·M·N·K at the logical depth kh·kw·Cin over the int8 peak and its A, B and
C bytes, int8, int8 and int32, moved once over the HBM bandwidth) over the
device time of K6's kernels (its wgmma product and its pack) by name."""
from peaks import least_seconds

FRAGMENTS = ("mm_sm90_kernel", "::rows_kernel", "::tile_kernel")


def read(ctx):
    sl, prog = ctx.slice, ctx.program
    if sl is None or not sl.units:
        return None
    products = prog.int8_products(prog.request(0))
    spent = sl.seconds(sl.matching(FRAGMENTS))
    if not products or spent <= 0:
        return None
    least = sum(least_seconds(2.0 * m * n * k, m * k + n * k + 4 * m * n, "int8")
                for m, n, k in products)
    return 100.0 * least * sl.units / spent
