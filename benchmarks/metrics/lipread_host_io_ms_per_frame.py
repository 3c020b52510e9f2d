"""Time of the lipreading entry's ``lipread/upload`` (the request's frames
and face boxes copied to the card from pageable memory) and
``lipread/fetch`` (the log-probs back to the host) spans in which the card
computed nothing (idle, or copying), in ms per frame of the slice.
``.cpu()`` in ``lipread/fetch`` first waits for the forward's kernels; that
wait is the model's time and is left out."""
import program_spans

SPANS = ("lipread/upload", "lipread/fetch")


def read(ctx):
    return program_spans.per_unit(ctx.slice, SPANS, "frames", program_spans.COMPUTE_CATS)
