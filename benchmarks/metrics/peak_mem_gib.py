"""The allocator's peak device memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
