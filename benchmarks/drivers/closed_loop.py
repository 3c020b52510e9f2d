"""Closed-loop serving: one client sends request 0, 1, 2, ... of the
program, each as soon as the previous one has come back, for the window's
seconds; the request that is running when they are up finishes inside the
window. A request's latency runs from the call to its result on the host.

Mix parameters read here: ``warmup_requests`` (set-up), ``check_requests``
(how many completed requests, drawn from the seed, the reference
recomputes), ``trace_requests`` (the profiled slice). The rest of the mix
describes the requests and is read by the configuration's ``Program``.
"""
from __future__ import annotations

import sys
import time
import traceback

from torch.profiler import record_function

import weights
from harness import Window


def warm_up(program, mix: dict) -> None:
    for k in range(mix["warmup_requests"]):
        program.serve(program.request(-1 - k))


def window(program, mix: dict, seed: int, seconds: float) -> Window:
    """The measured window. The requests kept for the comparison are a
    uniform sample of the completed ones: each index gets a key drawn from
    the seed, and the ``check_requests`` smallest keys are kept."""
    keys = weights.rng(seed, 5)
    w = Window()
    kept = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        req = program.request(i)
        w.attempted += 1
        start = time.perf_counter()
        try:
            out = program.serve(req)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
            break
        w.latencies_s.append(time.perf_counter() - start)
        w.frames += req.n_frames
        w.requests += 1
        kept.append((float(keys.random()), i, req, out))
        kept = sorted(kept, key=lambda k: k[0])[:mix["check_requests"]]
        i += 1
    w.seconds = time.perf_counter() - t0
    w.kept = [(req, out) for _, _, req, out in sorted(kept, key=lambda k: k[1])]
    return w


def traced(program, mix: dict):
    """The profiled slice: ``trace_requests`` whole requests → (frames, requests)."""
    frames = 0
    for k in range(mix["trace_requests"]):
        req = program.request(-1000 - k)
        with record_function("bench/request"):
            program.serve(req)
        frames += req.n_frames
    return frames, mix["trace_requests"]
