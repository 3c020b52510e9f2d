"""Device time of host-to-device and device-to-host memcpys in the traced
slice, in ms per frame produced."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.frames:
        return None
    ops = sl.copies(("HtoD", "DtoH"))
    return sl.seconds(ops) * 1e3 / sl.frames if ops else None
