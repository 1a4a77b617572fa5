"""What several metric readers share: reading the traced part of a run."""

from __future__ import annotations


def idle_pct(run):
    """100 x (1 - busy / window) of the traced part; over several ranks,
    their mean.  None without a trace or where nothing ran on the device."""
    traces = getattr(run, "rank_traces", None) or ([run.trace] if run.trace else [])
    shares = [1.0 - t.busy_s / t.window_s for t in traces if t.window_s > 0 and t.busy_s > 0]
    if not shares:
        return None
    return 100.0 * sum(shares) / len(shares)


def op_seconds_in(run, needle: str, mark: str) -> float:
    """Device seconds of the operations named with ``needle`` that started
    inside the host annotation ``mark`` of the traced part."""
    t = run.trace
    if t is None or mark not in t.marks:
        return 0.0
    a, b = t.marks[mark]
    return t.seconds(needle, a, b)


# The program's kernels: its CUDA library's namespace, as the profiler names
# them.
PORT_KERNEL = "spt::"
STEP_MARK = "step"


def in_step(run):
    """The device operations of the traced fit step (None without one)."""
    t = getattr(run, "trace", None)
    if t is None or STEP_MARK not in t.marks:
        return None
    a, b = t.marks[STEP_MARK]
    return [o for o in t.ops if a <= o[1] < b]


def step_roofline(run, needle: str, flops_per_test: int):
    """A scan kernel's roofline share over the traced step (None where the
    step holds no launch of it or no segment count)."""
    from . import peaks

    ops = in_step(run)
    segs = getattr(run, "segments", None)
    if ops is None or not segs:
        return None
    dev_s = sum(d for n, _, d, _ in ops if needle in n)
    least = peaks.scan_least_seconds(segs, run.live_spheres, flops_per_test)
    return peaks.roofline_pct(least, dev_s)
