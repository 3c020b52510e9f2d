"""Kernels, copies and memsets on the card in the traced slice over the
frames the slice produced: the entry's host dispatch per frame."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.frames or not sl.device:
        return None
    return len(sl.device) / sl.frames
