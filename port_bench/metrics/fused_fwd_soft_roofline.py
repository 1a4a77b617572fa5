"""grad_fwd_kernel<kSoft>'s share of its roofline over the traced camera-fit
step: the least time of the step's soft scans (every live ray-bounce of the
step's samples, counted by the reference, x live spheres x 32 FP32
operations at 67 TFLOP/s) over the summed device time of every launch of
the kernel in that step."""

from pb_core import peaks
from pb_core.readers import step_roofline


def read(run):
    return step_roofline(run, "grad_fwd_kernel<1>", peaks.FLOPS_SOFT_TEST)
