"""The chip's published peaks and the work the kernels' inputs need
(frozen: a later change that does less work is measured against these).

NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 67 TFLOP/s of
FP32 outside the tensor cores, 3.35 TB/s of HBM3.  One hard ray-sphere
test is 20 FP32 operations (the direct |oc|^2 form: 3 subtractions, the
two dot products' 5 multiplies and 4 adds, r^2 - (oc^2 - tc^2): 3, the
square root, the two roots and the compares); a soft one 32 (the hard
test's 20, the acceptance threshold's multiply and compare, the validity
coin's two, the blocker's score and its five compares).  The work of a
scan is every path's segments (bounces begun) times every live sphere:
the brute-force scan the program performs.  A program that culls spheres
reads above 100% against it and needs a benchmark change that recounts
the work first.
"""

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_HARD_TEST = 20
FLOPS_SOFT_TEST = 32


def scan_least_seconds(segments: int, live_spheres: int, flops_per_test: int) -> float:
    """The least time the scan of ``segments`` path segments over
    ``live_spheres`` spheres can take: bound by FP32 operations."""
    return segments * live_spheres * flops_per_test / PEAK_FP32


def roofline_pct(least_s: float, device_s: float):
    """100 x least time / device time; None where nothing ran."""
    if not device_s or device_s <= 0.0 or least_s is None:
        return None
    return 100.0 * least_s / device_s
