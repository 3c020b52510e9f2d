"""Frames completed in the window over the window's seconds (host clock):
lip-sync frames pasted back and on the host, sampled uint8 frames on the
host, or samples trained."""


def read(ctx):
    w = ctx.window
    return w.frames / w.seconds if w.seconds > 0 and w.frames else None
