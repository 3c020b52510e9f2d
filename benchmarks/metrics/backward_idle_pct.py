"""Share of the union of ``train/backward`` spans (``zero_grad`` and
``loss.backward()`` on the calling thread) in which no kernel, copy or
memset ran on the card, in %: device work counts wherever it was launched
from, the autograd engine's own thread included."""
import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.slice, ("train/backward",))
