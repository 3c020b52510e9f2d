"""The small-MHA kernel's (K2) share of its roofline in the traced slice:
the least time of the attention the slice's requests need (each call's
4·b·h·s²·d over the bf16 peak, or its Q, K, V and O in bf16 moved once
over the HBM bandwidth, whichever is larger) over the device time of K2's
kernels by name, whatever route runs them."""
from peaks import least_seconds

FRAGMENTS = ("small_mha_sm90_kernel", "small_mha_rows", "small_mha_general")


def read(ctx):
    sl, prog = ctx.slice, ctx.program
    if sl is None or not sl.units:
        return None
    calls = prog.attention_calls(prog.request(0))
    spent = sl.seconds(sl.matching(FRAGMENTS))
    if not calls or spent <= 0:
        return None
    least = sum(least_seconds(4.0 * b * h * s * s * d, 4 * b * h * s * d * 2, "bf16")
                for b, h, s, d, _ in calls)
    return 100.0 * least * sl.units / spent
