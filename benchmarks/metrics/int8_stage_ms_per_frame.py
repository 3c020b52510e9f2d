"""Device time of the kernels the program launches inside its int8
quantise, im2col and dequantise ranges (``ops/quant``'s ``record_function``
labels), less any K6 kernel among them, in ms per frame of the slice."""
RANGES = ("int8/quantise", "int8/im2col", "int8/dequantise")
K6 = ("mm_sm90_kernel", "::rows_kernel", "::tile_kernel")


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.frames:
        return None
    ops = [op for op in sl.launched_in(RANGES) if not any(f in op.name for f in K6)]
    return sl.seconds(ops) * 1e3 / sl.frames if ops else None
