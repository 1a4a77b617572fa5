"""persistent_kernel's share of its roofline in the traced frame of a lit
scene: the least time (``pb_core.peaks_lit``: the larger of the scan's FP32
time and the threefry evaluations' INT32 time, the work counted by the
reference over the whole frame) over the kernel's device time in that
frame."""

from pb_core import peaks, peaks_lit
from pb_core.readers import op_seconds_in


def read(run):
    work = getattr(run, "lit_work", None)
    if run.trace is None or not work:
        return None
    dev_s = op_seconds_in(run, "persistent_kernel", f"frame{run.traced_frame}")
    least = peaks_lit.lit_least_seconds(work["segments"], run.live_spheres, work["evals"])
    return peaks.roofline_pct(least, dev_s)
