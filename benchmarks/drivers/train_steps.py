"""Training steps back to back: the program's step ``i`` on batch ``i``
of its pool, its loss read on the host after each (as a loop that logs
its metrics does), for the window's seconds; the step running when they
are up finishes inside the window.

Set-up runs the state's first ``checked_steps`` steps through the same
call and feed (``first_steps``), which records what the reference is
compared with; the window goes on from there with the same state. Mix
parameters read here: ``checked_steps``, ``trace_steps``.
"""
from __future__ import annotations

import sys
import time
import traceback

from torch.profiler import record_function

from harness import Window


def warm_up(program, mix: dict) -> None:
    program.first_steps()


def window(program, mix: dict, seed: int, seconds: float) -> Window:
    w = Window()
    i = mix["checked_steps"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        w.attempted += 1
        start = time.perf_counter()
        try:
            program.step(i)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
            break
        w.latencies_s.append(time.perf_counter() - start)
        w.frames += mix["batch"]
        w.requests += 1
        i += 1
    w.seconds = time.perf_counter() - t0
    program.next_index = i
    return w


def traced(program, mix: dict):
    """The profiled slice: ``trace_steps`` whole steps → (samples, steps)."""
    i = getattr(program, "next_index", mix["checked_steps"])
    for k in range(mix["trace_steps"]):
        with record_function("bench/step"):
            program.step(i + k)
    return mix["trace_steps"] * mix["batch"], mix["trace_steps"]
