"""Device time of a call, without the host work of launching it."""
from __future__ import annotations

import torch


def graph_ms(fn, n: int = 50, replays: int = 5) -> float:
    """Device time of one call of ``fn``, ms: ``n`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events. No host
    work of the calls is in it: what a kernel launched from a loop on the
    host cannot show when its call costs more host time than it runs."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * replays)
