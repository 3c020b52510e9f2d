"""The flash attention kernels' (K3 forward, K4/K5 backward) share of
their roofline in the traced slice: the least time of the attention the
slice's shapes need (forward 4·b·h·s²·d, backward twice that, at the
logical shapes, over the bf16 peak; or Q, K, V and O, and in the backward
dO, dQ, dK and dV, in bf16 moved once) over the device time of the
kernels by name, whatever route runs them."""
from peaks import least_seconds

FRAGMENTS = ("flash_fwd", "flash_bwd", "tiled::fwd_kernel", "tiled::dkv_kernel",
             "tiled::dq_kernel", "::combine_kernel")


def read(ctx):
    sl, prog = ctx.slice, ctx.program
    if sl is None or not sl.units:
        return None
    calls = prog.attention_calls(prog.request(0))
    spent = sl.seconds(sl.matching(FRAGMENTS))
    if not calls or spent <= 0:
        return None
    least = 0.0
    for b, h, s, d, kind in calls:
        passes, tensors = (1, 4) if kind == "fwd" else (2, 8)
        least += least_seconds(passes * 4.0 * b * h * s * s * d, tensors * b * h * s * d * 2, "bf16")
    return 100.0 * least * sl.units / spent
