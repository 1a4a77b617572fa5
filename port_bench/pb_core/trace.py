"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activity) over a short steady part of the window, reduced to what the
per-layer readers need.

The traced part is marked by a host annotation (``MARK``); device
operations are the trace's kernels, copies and sets.  Busy time is the
union of their intervals inside the mark; idle gaps are the intervals
between them, each named by the innermost host event that was running at
the gap's middle.  The trace is written to a temporary directory (under
``TMPDIR``) and deleted once read: a traced part holds a few frames or one
fit step, a few MB.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

MARK = "pb.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)       # (name, start_s, seconds, category)
    gaps: list = field(default_factory=list)      # (host event name, seconds)
    marks: dict = field(default_factory=dict)     # annotation name -> (start_s, end_s)

    def seconds(self, needle: str, start: float | None = None, end: float | None = None) -> float:
        """Total device seconds of the operations named with ``needle`` that
        start in [start, end)."""
        return sum(d for n, s, d, _ in self.ops if needle in n
                   and (start is None or s >= start) and (end is None or s < end))

    def count(self, category: str, start: float, end: float) -> int:
        """Device operations of ``category`` that start in [start, end)."""
        return sum(1 for _, s, _, c in self.ops if c == category and start <= s < end)

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, _, d, _ in self.ops:
            by[n] = by.get(n, 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


class Tracer:
    """Profiles from ``start()`` to ``stop()``; ``annotate_begin(name)`` /
    ``annotate_end(name)`` mark a part of it (a frame, a step) on the host."""

    def __init__(self):
        self.prof = None
        self.mark = None
        self.open = {}

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def annotate_begin(self, name: str):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self.open[name] = rf

    def annotate_end(self, name: str):
        self.open.pop(name).__exit__(None, None, None)

    def stop(self) -> TraceSummary:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for name in list(self.open):
            self.annotate_end(name)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return summarize(events)


def summarize(events: list) -> TraceSummary:
    """Reduce a chrome trace's events (times in microseconds)."""
    marks, host, dev = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            marks[e["name"]] = (ts, ts + dur)
        if cat in DEVICE_CATS:
            dev.append((e["name"], ts, dur, cat))
        elif cat in HOST_CATS:
            host.append((e["name"], ts, dur, e.get("tid")))
    if MARK not in marks:
        raise RuntimeError("the trace holds no traced window")
    w0, w1 = marks[MARK]
    main_tid = next((t for n, s, d, t in host if n == MARK), None)
    ops = sorted((o for o in dev if o[1] < w1 and o[1] + o[2] > w0), key=lambda o: o[1])
    busy, gaps, cur_end = 0.0, [], w0
    intervals = []
    for _, s, d, _ in ops:
        s, e = max(s, w0), min(s + d, w1)
        if e <= s:
            continue
        if s > cur_end:
            intervals.append(("gap", cur_end, s))
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
    if w1 > cur_end:
        intervals.append(("gap", cur_end, w1))
    main = [(n, s, d) for n, s, d, t in host if t == main_tid and n != MARK]
    for _, a, b in intervals:
        mid = 0.5 * (a + b)
        over = [(d, n) for n, s, d in main if s <= mid <= s + d]
        gaps.append((min(over)[1] if over else "host idle", (b - a) * 1e-6))
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        ops=[(n, s * 1e-6, d * 1e-6, c) for n, s, d, c in ops],
        gaps=gaps, marks={k: (a * 1e-6, b * 1e-6) for k, (a, b) in marks.items()},
    )
