"""regen_idx_kernel<kSoft>'s share of its roofline over the traced fit step:
the least time of the step's soft scans (every path's segments over all the
step's samples, counted by the reference, x live spheres x 32 FP32
operations at 67 TFLOP/s) over the summed device time of every launch of
the kernel in that step."""

from pb_core import peaks
from pb_core.readers import step_roofline


def read(run):
    return step_roofline(run, "regen_idx_kernel<1>", peaks.FLOPS_SOFT_TEST)
