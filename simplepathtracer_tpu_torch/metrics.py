"""Throughput meter and profiler trace (counterpart of the JAX package's
``metrics.py``).

``Meter`` prints one JSON line per phase, with the JAX ``Meter``'s keys
(``phase``, ``elapsed_s``, ``paths``, ``paths_per_sec``,
``ray_segments_per_sec``), and marks each phase with a ``tracing`` span
``spt.cli.<phase>``.  ``profiler_trace`` records a ``torch.profiler`` trace
of a block into a directory, with the block's spans and counters
(``tracing``) beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from . import tracing


def _sync_cuda() -> None:
    """Wait for the card's queued work, where CUDA has been used: a phase
    that only launches kernels would otherwise time their enqueue."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Meter:
    """Phase timer and throughput meter emitting one JSON line per phase."""

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self.records = []

    def emit(self, record: dict) -> None:
        self.records.append(record)
        if self.enabled:
            print(json.dumps(record), file=self.stream, flush=True)

    @contextlib.contextmanager
    def phase(self, name: str, paths: int | None = None, bounces: int | None = None):
        """Time the block, the card's work included: the clock is read after
        ``torch.cuda.synchronize()`` on both sides, so ``paths_per_sec`` is
        the card's rate, not the launch rate.  The block is the span
        ``spt.cli.<name>``."""
        _sync_cuda()
        t0 = time.perf_counter()
        with tracing.span(f"spt.cli.{name}"):
            yield
        _sync_cuda()
        dt = time.perf_counter() - t0
        rec = {"phase": name, "elapsed_s": round(dt, 4)}
        if paths:
            rec["paths"] = paths
            rec["paths_per_sec"] = round(paths / dt, 1)
            if bounces:
                rec["ray_segments_per_sec"] = round(paths * bounces / dt, 1)
        self.emit(rec)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace of the block (CPU activity, and CUDA
    where the card is present), exported as a Chrome trace
    ``trace.json`` in ``logdir`` (open it in Perfetto or chrome://tracing),
    and beside it ``spans.json``: the block's span records
    (``tracing.spans()``, a new period of tracing) under ``spans`` and what
    the block added to the process's counters under ``counts``.  Yields the
    profiler, or None without a ``logdir``."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = tracing.counts()
    with profile(activities=activities) as prof, tracing.enabled():
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": tracing.spans(), "counts": dict(tracing.counts() - before)}, f)
