"""90th percentile of the latency of every request completed in the
window, from the call to the result on the host (host clock), in ms."""
from harness import quantile


def read(ctx):
    lat = ctx.window.latencies_s
    return quantile(lat, 0.9) * 1e3 if lat else None
