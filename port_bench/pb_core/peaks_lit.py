"""The least time of a lit frame's persistent kernel (frozen: a later change
that does less work is measured against these).

A frame of a closed, emitter-lit scene does little scanning (a few live
spheres) and much per-bounce work; its least time is the larger of two:

* the scan's FP32 time: segments x live spheres x 20 operations (one hard
  test, ``peaks.FLOPS_HARD_TEST``) at ``peaks.PEAK_FP32``;
* the RNG's INT32 time: the frame's threefry2x32 evaluations (2 a path for
  the camera ray, 3 a hit, 1 a Russian-roulette draw; counted by the
  reference, ``pb_reference.forward_lit``) x ``INT_OPS_THREEFRY`` at
  ``PEAK_INT32``.

One evaluation of the program's threefry2x32 (common.cuh, ``threefry2x32``)
is at least 73 integer operations, counted from its source as the card can
issue them: ks2 = k0 ^ k1 ^ C, 1 (a three-input LOP3); the two counter
adds, 2; 20 rounds of x0 += x1, x1 = rotl(x1, r), x1 ^= x0, 3 each (the
rotate one funnel shift), 60; 5 key injections of x0 += k and x1 += k' + i,
2 each (x1's a three-input IADD3), 10.  As written, with the rotate's two
shifts and OR and each add and XOR apart, it is 119; the least time takes
the smaller count.  The two uniforms' conversions to float are not counted.

H100 SXM INT32 rate: 132 SMs x 64 INT32 lanes a clock (NVIDIA H100 Tensor
Core GPU Architecture whitepaper, 2022: an SM issues 64 INT32 operations a
clock) at the 1.98 GHz that the 67 TFLOP/s FP32 figure implies (132 x 128
FP32 lanes x 2 x 1.98 GHz), 16.7 Tops/s.
"""

from . import peaks

SMS = 132
FP32_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
CLOCK_HZ = peaks.PEAK_FP32 / (SMS * FP32_LANES_PER_SM * 2)
PEAK_INT32 = SMS * INT32_LANES_PER_SM * CLOCK_HZ
INT_OPS_THREEFRY = 73


def rng_least_seconds(evals: int) -> float:
    """The least time of ``evals`` threefry2x32 evaluations: INT32 bound."""
    return evals * INT_OPS_THREEFRY / PEAK_INT32


def lit_least_seconds(segments: int, live_spheres: int, evals: int) -> float:
    """The least time of a lit frame: its scan's FP32 time or its RNG's
    INT32 time, whichever is larger."""
    scan = peaks.scan_least_seconds(segments, live_spheres, peaks.FLOPS_HARD_TEST)
    return max(scan, rng_least_seconds(evals))
