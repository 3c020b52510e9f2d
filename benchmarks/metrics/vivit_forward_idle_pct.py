"""Share of the union of the lipreading entry's ``lipread/forward`` spans
(the classifier's host dispatch: ``predict_sharded`` and the ViViT's
launches) in which no kernel, copy or memset ran on the card, in %."""
import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.slice, ("lipread/forward",))
