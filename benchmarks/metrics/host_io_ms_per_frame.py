"""Time of the lip-sync entry's ``lipsync/gather`` (a batch's rows indexed
on the host and copied to the card), ``lipsync/fetch`` (the batch back to
the host) and ``lipsync/concat`` (the request's frames assembled) spans in
which the card computed nothing (idle, or copying), in ms per frame of the
slice. ``.cpu()`` in ``lipsync/fetch`` first waits for the batch's kernels;
that wait is the generator's time and is left out."""
import program_spans

SPANS = ("lipsync/gather", "lipsync/fetch", "lipsync/concat")


def read(ctx):
    return program_spans.per_unit(ctx.slice, SPANS, "frames", program_spans.COMPUTE_CATS)
