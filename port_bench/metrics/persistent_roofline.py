"""persistent_kernel's share of its roofline in the traced frame: the least
time of the frame's brute-force scan (every path's segments, counted by the
reference, x live spheres x 20 FP32 operations at 67 TFLOP/s) over the
kernel's device time in that frame."""

from pb_core import peaks
from pb_core.readers import op_seconds_in


def read(run):
    segs = getattr(run, "segments", None)
    if run.trace is None or not segs:
        return None
    dev_s = op_seconds_in(run, "persistent_kernel", f"frame{run.traced_frame}")
    least = peaks.scan_least_seconds(segs, run.live_spheres, peaks.FLOPS_HARD_TEST)
    return peaks.roofline_pct(least, dev_s)
