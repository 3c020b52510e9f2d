"""Share of the union of the sampler's ``sample/step`` spans (one a DDIM
step: the U-Net's denoise and the scheduler's update) in which no kernel,
copy or memset ran on the card, in %."""
import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx.slice, ("sample/step",))
