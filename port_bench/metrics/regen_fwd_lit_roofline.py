"""The emissive idx-only regen forward's (``regen_idx_lit_kernel``) share of
its roofline over the traced fit step: the least time of the step's
forward passes (``pb_core.peaks_regen_lit``: the larger of the scan's FP32
time and the threefry evaluations' INT32 time, the work of every sample of
the step counted by the reference) over the summed device time of every
launch of the kernel in that step."""

from pb_core import peaks, peaks_regen_lit
from pb_core.readers import in_step

KERNEL = "regen_idx_lit_kernel<"


def read(run):
    ops, work = in_step(run), getattr(run, "work", None)
    if ops is None or not work:
        return None
    dev_s = sum(d for n, _, d, _ in ops if KERNEL in n)
    least = peaks_regen_lit.fwd_least_seconds(work["segments"], run.live_spheres,
                                              work["evals"], run.softness > 0.0)
    return peaks.roofline_pct(least, dev_s)
