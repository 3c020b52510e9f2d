"""The traced slice: a fixed number of whole requests or steps profiled by
``torch.profiler`` (CPU and CUDA activities), written as a Chrome trace
under ``out/`` and reduced to what the metric readers need.

Times in the trace are microseconds on one clock for host and device. The
slice's window runs from the start of its first ``bench/...`` range (the
driver's own, around each request or step) to the end of its last. Device
work is every kernel, memcpy and memset in it; the card is busy where the
union of their intervals lies, so overlapping work counts once.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench/"
_NAME_CHARS = 120


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float      # us
    end: float        # us
    correlation: Optional[int]


@dataclasses.dataclass
class HostOp:
    name: str
    start: float
    end: float
    tid: object


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals covering the same points as ``intervals``."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union(intervals))


@dataclasses.dataclass
class Slice:
    w0: float
    w1: float
    device: List[DeviceOp]
    host: List[HostOp]
    launches: Dict[int, Tuple[float, object]]
    main_tid: object = None       # the thread of the bench/ ranges
    frames: int = 0
    units: int = 0                # requests or steps in the slice

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return covered((op.start, op.end) for op in self.device) * 1e-6

    def seconds(self, ops: Iterable[DeviceOp]) -> float:
        return sum(op.end - op.start for op in ops) * 1e-6

    def matching(self, fragments: Sequence[str]) -> List[DeviceOp]:
        """Device ops whose name holds one of ``fragments``."""
        return [op for op in self.device if any(f in op.name for f in fragments)]

    def copies(self, kinds: Sequence[str] = ("HtoD", "DtoH")) -> List[DeviceOp]:
        return [op for op in self.device if op.cat == "gpu_memcpy"
                and any(k in op.name for k in kinds)]

    def launched_in(self, prefixes: Sequence[str]) -> List[DeviceOp]:
        """Device ops launched (by their runtime call's time and thread)
        inside a host range whose name starts with one of ``prefixes``."""
        ranges = defaultdict(list)
        for h in self.host:
            if any(h.name.startswith(p) for p in prefixes):
                ranges[h.tid].append((h.start, h.end))
        merged = {tid: union(r) for tid, r in ranges.items()}
        starts = {tid: [s for s, _ in r] for tid, r in merged.items()}
        out = []
        for op in self.device:
            launch = self.launches.get(op.correlation)
            if launch is None or launch[1] not in merged:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and merged[tid][i][1] >= ts:
                out.append(op)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device ops that took most time, by name, and the longest idle
        gaps summed by the innermost host op running at their middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.device:
            by_name[op.name[:_NAME_CHARS]] += (op.end - op.start) * 1e-6
        busy = union((op.start, op.end) for op in self.device)
        edges = [self.w0] + [t for iv in busy for t in iv] + [self.w1]
        main = sorted((h for h in self.host if h.tid == self.main_tid), key=lambda h: h.start)
        starts = [h.start for h in main]
        gaps: Dict[str, float] = defaultdict(float)
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid, name = 0.5 * (s + e), "(no host op)"
            # host ops of one thread nest: the covering op that started last is the innermost
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if main[i].end >= mid:
                    name = main[i].name
                    break
            gaps[name[:_NAME_CHARS]] += (e - s) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}


def parse(events: List[dict]) -> Slice:
    """A Slice from Chrome-trace events (``traceEvents``)."""
    device, host, launches = [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(DeviceOp(ev["name"], cat, ts, ts + dur, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ts, ev.get("tid"))
        elif cat in HOST_CATS:
            host.append(HostOp(ev["name"], ts, ts + dur, ev.get("tid")))
    spans = [h for h in host if h.name.startswith(SPAN_PREFIX)]
    if not spans:
        raise ValueError("the trace has no bench/ range: nothing was profiled")
    w0, w1 = min(h.start for h in spans), max(h.end for h in spans)
    inside = []
    for op in device:
        s, e = max(op.start, w0), min(op.end, w1)
        if e > s:
            inside.append(dataclasses.replace(op, start=s, end=e))
    return Slice(w0, w1, inside, host, launches, spans[0].tid)


def profile_slice(fn: Callable[[], Tuple[int, int]], path: Path, device: str) -> Slice:
    """Run ``fn`` (→ (frames, units) it produced) under ``torch.profiler``,
    write the Chrome trace to ``path`` and return its Slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        frames, units = fn()
        if device == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    sl = parse(data["traceEvents"] if isinstance(data, dict) else data)
    sl.frames, sl.units = frames, units
    return sl
