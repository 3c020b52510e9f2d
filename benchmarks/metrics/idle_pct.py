"""Share of the traced slice's wall time in which no kernel, copy or
memset ran on the card: 100·(1 − union of device intervals / window)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0 or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
