"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py               # what the checks below need
    python3 chip_smoke.py --sweep       # also time lane balancing
    python3 chip_smoke.py --camera-adfd # also the cover camera gradient
                                        # against FD, coordinate by coordinate

Builds the CUDA kernels from the sources in the checkout (one nvcc per
source, in parallel) and holds each against its plain PyTorch version on
the card.  Phases 1-4 serve the forward render: the persistent kernel
against its plain version, balancing, the full-width ``cover`` preset
(1200x800, 100 spp, depth 10, thin-lens defocus) through ``render()``, and
2,048 random pixels of that frame re-rendered by the plain version (bit for
bit), with the kernel's registers, spill and resident grid; phase 4e the
kernel's emissive build on the ``smallpt`` preset's full frame at 16 spp
(``render()`` through it alone, 2,048 random pixels bit for bit against the
plain version, its time, bound and registers).  Phases 5-6 serve inverse rendering: the regeneration forward (both
modes), re-forward, backward and bucket kernels against their plain
versions at small shapes, through ``pixel_loss`` on 2,048 random pixels of
the full frame, and kernel by kernel at one full-width chunk (2,048 random
lanes against the plain versions, the bucket against ``index_add_``); the
regen forward against the persistent kernel over the full frame, with
every sample also run alone to find the paths that differ; and ``fit`` on
the full frame (albedo and sky fitted, centers and radii frozen), whose
loss must fall and which must run through the kernels only.  Phase 5
also holds the soft-silhouette instantiations against their plain versions
(sphere-only, and plane + Russian roulette + spp chunks), and phase 7
drives soft silhouettes on the main path: ``fit`` with its own defaults
(softness 0.02, every leaf, the decoupled loss) on the full cover frame
through the soft kernels only, each soft kernel at that fit's chunk on
2,048 random lanes against its plain version, the plane leaf of
``three_sphere_plane`` at its full size (the crossing coin live), and the
half-buried radius AD/FD of tests/test_crossing.py through the kernels.
Phase 7e drives gradients of an emitter-lit scene on their main path (the
benchmark cell ``smallpt_fit.fit_lit``'s shape): ``fit`` of the
``smallpt`` frame at 64 spp with its defaults and the emission leaf,
through the emissive builds only (launches counted from zero over the
timed steps; the light's emission must rise), and each emissive kernel
(idx-only and full-residual forward, backward, the 12-column bucket) and
the re-forward at that fit's 8-spp chunk on 2,048 random lanes against
their plain versions, with their times and bounds.
Phase 8 drives camera gradients through the per-bounce fused kernels
(``csrc/grad.cu``): raygen, every forward and backward bounce against
their plain versions at small shapes (bit for bit; sky sums and buckets
against float64 sums), the fused scene-leaf route at bench.py's shape
(cover 1200x800, 8 spp in one chunk: value_and_grad of ``pixel_loss``
against the regeneration route on the same key), ``fit_camera`` on the
full cover frame with its defaults through the fused kernels only (loss
must fall; its first gradient must descend the loss and, on a Lambertian
copy of the frame, have each strong coordinate's sign by central
differences), each fused kernel at both paths' launch shapes on 2,048
random rays against its plain version (the forward timed per bounce, with
its ns per live ray-bounce), AD/FD of ``vfov_deg`` through the
kernels, README's ``fit_camera`` example, and the camera-jitter kernel
(``csrc/camera_jitter.cu``, the uniforms of the eager camera rays) at the
camera fit's 48 M-ray launch against its plain version, bit for bit, timed
beside its bound.  Phase 9 drives the
explicit-ray forward and the ``use_pallas_hits`` gradient route
(``csrc/bounce_step.cu``, ``csrc/closest_hit.cu``): the bounce-step kernel
and both closest-hit kernels against their plain versions on every bounce
of small traces (bit for bit); ``render_pixels`` of the cover preset over
the full frame x 8 spp through the bounce-step and camera-jitter kernels (each launch timed,
2,048 random rays against the plain version, per-pixel sums against the
persistent kernel: the knife-edge bound); ``fit`` through the hits route
(closest-hit-attributes and bucket kernels only; the loss must fall; its
first value and gradient against the fused route on the same rays, and
the kernel at each bounce of a chunk on 2,048 random rays); and
``intersect_scene_pallas`` on the full frame's camera rays.  Phase 10 drives
the command line (``simplepathtracer_tpu_torch.cli.main`` in this process)
on the cover preset at full width, each command with the launch counts set
to 0 just before it: a render in two chunks with snapshots under
``--trace`` (the trace must show the persistent kernel), a render stopped
at 50 spp and resumed (bit for bit the first one's accumulation and BMP),
``invert --preset cover`` with fit snapshots and the same command again
(it must resume and run no step), ``--grad-accum 4`` with each group's
peak memory, the small invert demo (fused kernels), ``fit(balance=True)``
against the unbalanced hard fit (the CLI's CUDA default follows it), and
a fit snapshot's round trip.  Comparisons of earlier
phases against the plain versions run at cut depths or chunks where the
plain versions' time would grow past the script's budget.  Every phase
raises on failure.  The last lines are one JSON object with the kernels'
numbers and one with the device; without CUDA the script exits non-zero
and prints neither.  Imports nothing of JAX.

At each full-width chunk it holds the full-residual forward's and the
re-forward's dead entries to their contract on every (iteration, lane):
alive 1 exactly below the lane's count and 0 from it on, idx (soft: the
blocker's index) -1 there.

It also prints the registers, spill and stack of every regen forward,
re-forward, regen backward and fused backward instantiation and of the
closest-hit-attributes and bounce-step kernels, the regen forward's
live-lane share (the fixed map's from the lanes' counts, the lane
fetch's from the kernel's counters) and resident grid, store-only passes
over the re-forward's dead entries (in a one-thread-per-lane tail's
order and row by row), the regen backward's warp live share and a
store-only pass over its cotangent planes, the fused backward per bounce
with ns per live ray-bounce, the bounce step per bounce of
``render_pixels`` with its live rays and the groups of 32 rays holding
one, the closest-hit-attributes kernel per bounce of the hits fit, and
the step times of the hard, default soft, camera, hits and plane fits.

For the bucket kernel it prints the key coherence of every chunk it
buckets at full width (rows cut into groups of 32 consecutive rows, as a
warp reads them: the share of groups whose rows that name a sphere hold
one key, the mean distinct keys per group, the busiest slot's share of
those rows), its time at every shape the main paths give it (the hard and
soft chunks, the plane fit's chunk, the fused route's step, the hits
route's bounces) and both instantiations' registers; for the
index-and-t closest hit its time alone and through its wrapper, its
registers, and a grazing ray set (tangent, an ulp off, from inside, near
root at t_min; all, some and no rays alive) bit for bit against its plain
version.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from io import StringIO

import numpy as np
import torch

# The script's own wall time is counted from here.
_T_IMPORT = time.perf_counter()

# One sphere test is 20 FP32 operations (csrc/persistent.cu, closest_hit).
FLOPS_PER_SPHERE_TEST = 20
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Pixels of the full cover frame that phases 4 and 6 also run through the
# plain versions.
N_CHECK_PIXELS = 2048
# Phase 4e: samples of smallpt's frame, and the INT32 side of its bound:
# integer operations of one threefry2x32 (common.cuh, as the card can issue
# them: port_bench/pb_core/peaks_lit.py) at 132 SMs x 64 lanes x 1.98 GHz.
SMALLPT_SPP = 16
THREEFRY_INT_OPS = 73
PEAK_INT32 = 132 * 64 * PEAK_FP32 / (132 * 128 * 2)
# JAX's bound for regen gradients (tests/test_pallas_grad_regen.py).
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6
# Backward kernel against its plain version: expected bit-exact.
BWD_RTOL = 1e-5
# Bucket against index_add_: atomics add in a changing order.  At full width
# an entry sums up to ~2e7 rows, at the small shapes of phase 5 a few
# thousand, whose signs may cancel (the blocker's columns), so neither
# float32 sum is held to the other relative to the sum alone.  A float32 sum
# of n rows in any order errs by at most (n - 1) roundings of the sum of
# their magnitudes; against a float64 index_add_ the kernel may be off by
# BUCKET_SUM_ROUNDINGS of them (the kernel's blocked sums err by about 1; a
# float32 index_add_, one long chain of atomics per entry, by 5 to 30 on the
# cover chunk's rows; a missing block or row still shows).
BUCKET_RTOL, BUCKET_ATOL_REL = 1e-5, 1e-7
F32_EPS = 2.0 ** -23
BUCKET_SUM_ROUNDINGS = 8
# Operations per lane-iteration of the backward (bounce forward ~150, its
# adjoint ~250 FP32 operations; threefry's integer work not counted).
BWD_OPS_PER_ITER = 400
# Residual planes of one lane-iteration (csrc/grad_regen.cu), 4 B each;
# the cotangent planes come from ops/grad_regen._n_planes.
N_RES_PLANES = 25
# Regen forward against the persistent kernel (different hit rebuild, so
# knife-edge winners may flip): |d| > 1e-4 on fewer than this share of
# channels at this spp (tests/test_pallas_bounce.py:44-46).  A path whose
# radiance differs by more than FLIP_TOL in a channel, or whose bounce
# count differs, is a flipped path.
KNIFE_EDGE_SHARE, KNIFE_EDGE_SPP = 0.005, 8
FLIP_TOL = 1e-4
# The fit of phase 6: Adam steps timed, learning rate, start point.
FIT_STEPS, FIT_LR = 3, 2e-2
ALBEDO_START, SKY_START = 0.6, 0.8
# Phase 7, soft silhouettes: fit()'s default softness; the start's offset
# of three object centers (cover spheres 1-3, along x); the half-buried
# radius AD/FD check of tests/test_crossing.py:132-169 and its bound.
DEFAULT_SOFTNESS = 0.02
CENTER_START = 0.05
ADFD_SOFTNESS, ADFD_EPS, ADFD_BOUNDS = 0.05, 4e-3, (0.3, 1.8)
# One soft sphere test is ~32 FP32 operations (csrc/common.cuh,
# closest_hit_soft: the hard test's 20 plus the clamp, two thresholds, the
# blocker's score and five compares).
FLOPS_PER_SOFT_SPHERE_TEST = 32
# Backward, soft: the hard 400 plus the ratio's forward (~130: six exp,
# the blocker's root, the crossing factor) and adjoint (~220).
BWD_OPS_PER_ITER_SOFT = 750
N_RES_PLANES_SOFT = 30
N_BLK_PLANES = 4
# Steps of the default soft fit timed with SIL_FRESNEL on and off again
# (phase 7).
FRESNEL_STEPS = 2
# Phase 7e, the lit fit (port_bench/traffic/fit_lit.json's shape): spp,
# the target's spp, the mirror and glass balls' slots, the light's slot and
# the start's emission scale.
LIT_SPP, LIT_TARGET_SPP = 64, 16
LIT_BALLS, LIT_LIGHT = [5, 6], 7
LIT_EMISSION_START = 0.7

_SRC = "simplepathtracer_tpu_torch/csrc/"
_JAX = "simplepathtracer_tpu/ops/"
# (name, source, TPU kernel replaced) of the gradient path's kernels.
GRAD_KERNELS = (
    ("regen_fwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:133"),
    ("regen_refwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:1095"),
    ("regen_bwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:462"),
    ("bucket", _SRC + "bucket.cu", _JAX + "pallas_bucket.py:50"),
)
# The soft-silhouette instantiations (the same TPU kernels' soft branches;
# the blocker bucket is bucket.cu with 4 columns).
SOFT_KERNELS = (
    ("regen_fwd_soft", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:133"),
    ("regen_refwd_soft", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:1095"),
    ("regen_bwd_soft", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:462"),
    ("bucket_blocker", _SRC + "bucket.cu", _JAX + "pallas_bucket.py:50"),
)
# Soft silhouettes with a ground plane (the crossing coin).
SOFT_PLANE_KERNELS = (
    ("regen_fwd_soft_plane", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:133"),
    ("regen_refwd_soft_plane", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:1095"),
    ("regen_bwd_soft_plane", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:462"),
)
# Phase 7e, the emissive builds on the lit fit's path (no TPU counterpart:
# the JAX package has no emission; the re-forward is the unlit build, its
# planes do not depend on emission).
LIT_KERNELS = (
    ("regen_fwd_soft_emit", _SRC + "grad_regen.cu", None),
    ("regen_refwd_soft_emit", _SRC + "grad_regen.cu", None),
    ("regen_bwd_soft_emit", _SRC + "grad_regen.cu", None),
    ("bucket_emit", _SRC + "bucket.cu", None),
)
# Phase 8, camera gradients: the per-bounce fused kernels (hard and soft
# instantiations) and raygen.
FUSED_KERNELS = (
    ("grad_fwd", _SRC + "grad.cu", _JAX + "pallas_grad.py:352"),
    ("grad_bwd", _SRC + "grad.cu", _JAX + "pallas_grad.py:470"),
    ("grad_fwd_soft", _SRC + "grad.cu", _JAX + "pallas_grad.py:352"),
    ("grad_bwd_soft", _SRC + "grad.cu", _JAX + "pallas_grad.py:470"),
    ("raygen", _SRC + "grad.cu", _JAX + "pallas_grad.py:652"),
)
# The fused scene-leaf route at bench.py's fwd_bwd_paths_per_sec shape
# (cover, 8 spp in one chunk); the camera fit's start (origin offset, vfov
# offset in degrees); AD/FD of vfov (tests/test_camera_grad.py:21-52: eps,
# and rtol 0.25 as bounds).
FUSED_SPP = 8
# Steps the fused scene-leaf route is timed over (~22 ms each on the card:
# 3 steps read 21.5-21.7 ms from one run to the next, more than the gain a
# raygen change can show).
FUSED_STEPS = 10
# Chunks, samples per chunk and depth that phase 6 runs through the plain
# route (its time grows with each; the fit's own chunk and depth are held
# kernel by kernel in phase 6 (e)).
CHECK_CHUNKS, CHECK_SPP_CHUNK, CHECK_DEPTH = 2, 10, 5
CAM_ORIGIN_START, CAM_VFOV_START = (0.05, -0.05, 0.0), 0.3
VFOV_ADFD_EPS, VFOV_ADFD_BOUNDS = 0.05, (0.75, 1.25)
# Camera AD against central differences on the main path (phase 8c): the
# step in the camera coordinates (a third of it moved no difference by more
# than 7%), and, on the Lambertian control, the share of the largest
# difference from which a coordinate must have the gradient's sign.
CAM_FD_EPS, CAM_SIGN_SHARE = 0.01, 0.25
# Phase 9, the explicit-ray forward and the use_pallas_hits gradient route:
# the bounce-step and closest-hit kernels.  Both main paths run at bench.py's
# fwd_bwd shape, the cover frame x FUSED_SPP samples.
EXPLICIT_KERNELS = (
    ("bounce_step", _SRC + "bounce_step.cu", _JAX + "pallas_bounce.py:56"),
    ("closest_hit_attrs", _SRC + "closest_hit.cu", _JAX + "pallas_intersect.py:161"),
    ("closest_hit", _SRC + "closest_hit.cu", _JAX + "pallas_intersect.py:47"),
)
# Bytes per ray each must move: the bounce step's 13 state planes and the
# pixel and sample ids in, 13 planes out (4 B each); the closest-hit
# kernels' origin and direction (24 B) and alive flag (a 1-B bool) in, and
# the index, 9 attributes and material (44 B) or the index and t (8 B) out.
BOUNCE_STEP_BYTES, ATTRS_BYTES, HIT_BYTES = 112, 69, 33
# The hits route against the fused route on the same key (phase 9c): loss
# relative difference, and each smooth leaf's gradient relative L2 error.
HITS_LOSS_RTOL, HITS_GRAD_L2 = 1e-4, 2e-2
# Raygen (phase 8b): bytes per ray each launch must move (the int32 pixel
# and sample ids in, the 6 float32 planes out), and the operations per ray
# that common.cuh's camera_ray states, counted from the source once (so the
# bound does not follow the kernel's own instructions).  Integer: each
# threefry2x32 call 72 (the two counter adds, 20 rounds of add, rotate and
# xor with the rotate one funnel shift, 5 key injections of two adds; the
# injected words are the launch's), the two calls sharing pix + k0 (143);
# the counters sid << 8 | 124 and | 125 (3); the four uniforms' >> 8 (4);
# the pixel's row and column by a multiply-high, a shift and a
# multiply-subtract (3).  FP32: the uniforms' scale (4), s01 and t01 (5),
# the lens radius and angle (2), ou and ov (2), origin (12), direction (15),
# its norm and scale (9); conversions 6; sqrt, sin, cos, rsqrt 4.  The
# rates: FP32 lanes issue PEAK_FP32 / 2 results per second (the peak counts
# an FMA as two), integer lanes half that (64 results per clock per SM
# against FP32's 128: CUDA C++ Programming Guide, compute capability 9.0),
# so the integer work sets the operations bound (153 at half rate against
# 212 at the full rate).
RAYGEN_BYTES = 32
RAYGEN_OPS = {"integer": 153, "fp32": 49, "conversion": 6, "special": 4}
# Rays per thread of the raygen kernel (csrc/grad.cu kRaygenRays).
RAYGEN_RAYS_PER_THREAD = 4
# The camera-jitter kernel (phase 8f, csrc/camera_jitter.cu): bytes per ray
# (the int64 pixel and sample ids in, one float4 out) and the operations
# per ray counted from the source once: integer, common.cuh's threefry2x32
# twice sharing pix + k0 (143, as RAYGEN_OPS counts it), the counters
# sid << 8, | 124 and | 125 (3), the four words' >> 8 (4); the four
# conversions; FP32, the four scales.  Integer at half the FP32 lanes' rate
# (as raygen's) sets the operations bound.
CAMERA_JITTER_BYTES = 32
CAMERA_JITTER_OPS = {"integer": 150, "fp32": 4, "conversion": 4}
# SASS opcodes (before the first dot) by the pipe that runs them.
SASS_PIPES = {
    "integer": {"IADD3", "IADD", "IMAD", "LOP3", "LOP", "SHF", "ISETP", "IMNMX", "IABS", "LEA",
                "SEL", "PRMT", "FLO", "POPC", "BMSK", "SGXT", "VIADD", "VIMNMX", "BREV"},
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET"},
    "conversion": {"I2F", "F2I", "I2FP", "F2F", "FRND", "F2IP"},
    "mufu": {"MUFU"},
    "memory": {"LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ATOMG", "ATOMS", "RED"},
}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?([A-Z0-9_.]+)([^;]*);")
# Report-name suffix of each regen kernel variant (ops/grad_regen.variant)
# and report name of each bucket column count.
VARIANT_SUFFIX = {"hard": "", "soft": "_soft", "soft_plane": "_soft_plane"}
BUCKET_NAMES = {9: "bucket", N_BLK_PLANES: "bucket_blocker", 12: "bucket_emit"}


def kernel_names(variant, emit=False):
    """Report names of the gradient kernels of one regen variant (``emit``:
    of an emissive call, ``_emit`` appended and the 12-column bucket)."""
    sfx = VARIANT_SUFFIX[variant] + ("_emit" if emit else "")
    return {"regen_fwd": "regen_fwd" + sfx, "regen_refwd": "regen_refwd" + sfx,
            "regen_bwd": "regen_bwd" + sfx, "bucket": "bucket_emit" if emit else "bucket"}


def gamma_image(sums, spp):
    return torch.clamp(sums / spp, 0.0, 1.0) ** 0.5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds per call over ``reps`` calls, after one warm call
    unless ``warm`` is False (a plain version that has just run on the same
    inputs)."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def persistent_split_ms(fn):
    """Device milliseconds of one call of ``fn`` (a persistent render) in
    ``persistent_kernel<...>`` and in ``persistent_kernel_combine``, from a
    ``torch.profiler`` trace (None where the profiler sees no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {"kernel": 0.0, "combine": 0.0}
    for e in prof.key_averages():
        if "persistent_kernel_combine" in e.key:
            got["combine"] += e.device_time_total / 1e3
        elif "persistent_kernel<" in e.key:
            got["kernel"] += e.device_time_total / 1e3
    return got if got["kernel"] > 0 else None


def ptxas_usage(log, entry):
    """Registers, spill stores and stack frame (bytes) that nvcc's
    ``-Xptxas -v`` printed for the kernel whose mangled name contains
    ``entry``."""
    out, seen = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            seen = entry in line
        elif seen and "bytes stack frame" in line:
            words = line.replace(",", "").split()
            out["stack_bytes"] = int(words[words.index("stack") - 2])
            out["spill_bytes"] = int(words[words.index("spill") - 2])
        elif seen and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out["registers"] = int(words[words.index("registers") - 1])
            seen = False
    return out


def sass_kernel(so_path, log, entry):
    """[(address, predicated, opcode, operands)] of the kernel whose mangled
    name contains ``entry`` (its first match among the entry functions of
    the nvcc ``log``), from ``cuobjdump -sass`` of that function alone."""
    from simplepathtracer_tpu_torch.ops.cuda_build import _nvcc

    names = [n for n in re.findall(r"Compiling entry function '([^']+)'", log) if entry in n]
    if not names:
        raise RuntimeError(f"no kernel named like {entry} in the nvcc log")
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_nvcc())), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", "-fun", names[0], str(so_path)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr[:500]}")
    ins, inside = [], False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = names[0] in line
        elif inside and (m := SASS_LINE.search(line)):
            ins.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4).strip()))
    if not ins:
        raise RuntimeError(f"cuobjdump printed no SASS for {names[0]}")
    return ins


def sass_pipe(opcode):
    base = opcode.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    return next((p for p, ops in SASS_PIPES.items() if base in ops), "other")


def sass_hot_path(ins):
    """The instructions a thread runs when it takes no slow path: from the
    kernel's entry to its last EXIT before the first subroutine, leaving
    out each region that a predicated forward branch skips and that holds a
    CALL or a loop of its own (the IEEE square root's special-value call,
    sincosf's Payne-Hanek reduction: no argument of the launches here takes
    them), innermost first, so that a region around them (a bounds check)
    stays."""
    def target(op, operands):
        word = operands.split()[-1] if operands else ""
        return int(word, 16) if op == "BRA" and word.startswith("0x") else None

    first_ret = next((i for i, x in enumerate(ins) if x[2].startswith("RET")), len(ins))
    main = ins[:max(i for i, x in enumerate(ins[:first_ret]) if x[2] == "EXIT") + 1]
    at = {x[0]: i for i, x in enumerate(main)}
    regions = sorted((at[t] - i, i, at[t]) for i, (a, pred, op, operands) in enumerate(main)
                     if pred and (t := target(op, operands)) is not None and t > a and t in at)
    skip = [False] * len(main)
    for _, i, j in regions:
        def rare(k):
            a, _, op, operands = main[k]
            t = target(op, operands)
            return op.startswith("CALL") or (t is not None and main[i][0] < t < a)
        if any(rare(k) and not skip[k] for k in range(i + 1, j)):
            skip[i + 1:j] = [True] * (j - i - 1)
    return [x for x, s in zip(main, skip) if not s]


def sass_counts(ins):
    counts = {}
    for x in ins:
        counts[sass_pipe(x[2])] = counts.get(sass_pipe(x[2]), 0) + 1
    counts["total"] = len(ins)
    counts["local"] = sum(x[2].split(".")[0] in ("LDL", "STL") for x in ins)
    return counts


def warp_live_share(cnt):
    """Live share of a one-thread-per-lane launch over lanes with ``cnt``
    live iterations each (lanes 32 w .. 32 w + 31 in warp w, each warp
    running until its longest lane ends): the lanes' iterations over 32 x
    the sum of the warps' longest counts."""
    c = cnt.double()
    pad = (-c.numel()) % 32
    warps = torch.cat([c, c.new_zeros(pad)]).view(-1, 32)
    return c.sum().item() / (32.0 * warps.amax(dim=1).sum().item())


def lane_shares(cnt, counts):
    """How a regen forward launch shared out its lanes' iterations: the
    fixed map's live-lane share (lanes 32 w .. 32 w + 31 in warp w, each
    warp running until its longest lane ends) and the lane fetch's
    (lane-iterations over the thread-iterations the kernel counted), with
    the resident grid's blocks (``counts``: the launch's span counts,
    ``tracing``)."""
    total = cnt.double().sum().item()
    return dict(fixed_map=warp_live_share(cnt),
                fetch=total / counts["thread_iters"], lane_iterations=total,
                thread_iterations=counts["thread_iters"], grid_blocks=counts["blocks"])


_LAP = [0.0]


@contextlib.contextmanager
def sil_fresnel(on=True):
    """``intersect.SIL_FRESNEL`` of the port set to ``on`` inside (the
    gradient calls read it when they are built)."""
    from simplepathtracer_tpu_torch.ops import intersect

    was = intersect.SIL_FRESNEL
    intersect.SIL_FRESNEL = on
    try:
        yield
    finally:
        intersect.SIL_FRESNEL = was


def fresnel_call(call):
    """``call`` (a regen or fused call) with the SIL_FRESNEL flag of its
    constants on, as ``scene_block`` sets it with the switch on."""
    consts = call.consts.clone()
    consts[-1] = 1.0
    return call._replace(consts=consts)


def lap(label=None):
    """Print the seconds since the previous lap under ``label`` (where a
    phase spends its time); with no label, only start a lap."""
    now = time.perf_counter()
    if label is not None:
        print(f"time: {label} {now - _LAP[0]:.2f} s")
    _LAP[0] = now


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gb(dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")


# (module of simplepathtracer_tpu_torch.ops, kernel wrapper, plain version)
# of each gradient kernel, and the kernels of each gradient route.
WRAPPER_SITES = {
    "regen_fwd": ("grad_regen", "regen_forward", "regen_fwd_reference"),
    "regen_refwd": ("grad_regen", "regen_refwd", "regen_refwd_reference"),
    "regen_bwd": ("grad_regen", "regen_backward", "regen_bwd_reference"),
    "bucket": ("bucket", "bucket_cols", "bucket_cols_reference"),
    "grad_fwd": ("grad", "grad_forward", "grad_fwd_reference"),
    "grad_bwd": ("grad", "grad_backward", "grad_bwd_reference"),
    "raygen": ("grad", "raygen", "raygen_reference"),
    "camera_jitter": ("sampling", "camera_jitter", "camera_jitter_reference"),
    "bounce_step": ("bounce_step", "bounce_step", "bounce_step_reference"),
    "closest_hit_attrs": ("closest_hit", "closest_hit_attrs", "closest_hit_attrs_reference"),
    "closest_hit": ("closest_hit", "closest_hit", "closest_hit_reference"),
}
REGEN_ROUTE = ("regen_fwd", "regen_refwd", "regen_bwd", "bucket")
FUSED_ROUTE = ("grad_fwd", "grad_bwd", "raygen", "bucket")
EXPLICIT_ROUTE = ("bounce_step",)
HITS_ROUTE = ("closest_hit_attrs", "bucket")


def grad_wrappers():
    """{name: (kernel wrapper, plain version)} of the gradient kernels."""
    out = {}
    for name, (mod, kernel, plain) in WRAPPER_SITES.items():
        m = importlib.import_module(f"simplepathtracer_tpu_torch.ops.{mod}")
        out[name] = (getattr(m, kernel), getattr(m, plain))
    return out


# The program's counters (``tracing.counts()``) when the counts were last
# reset: the reports count from there.
_COUNT_BASE = [None]


def reset_counts():
    from simplepathtracer_tpu_torch import tracing

    _COUNT_BASE[0] = tracing.counts()


def counts_since_reset():
    from simplepathtracer_tpu_torch import tracing

    return tracing.counts() - _COUNT_BASE[0]


def launch_counts():
    """Launches since the counts were reset, by report name: each regen and
    fused kernel by variant (a regen launch of an emissive call under its
    ``_emit`` name alone), the bucket by column count, the others by name
    (the persistent kernel's apart, ``route_counts``)."""
    names = {"regen_forward": "regen_fwd", "regen_refwd": "regen_refwd",
             "regen_backward": "regen_bwd", "grad_forward": "grad_fwd",
             "grad_backward": "grad_bwd"}
    out = {}
    for key, n in counts_since_reset().items():
        parts = key.split(".")
        if parts[0] != "launch" or parts[1] == "persistent":
            continue
        if parts[1] == "bucket":
            out[BUCKET_NAMES[int(parts[2])]] = n
        elif parts[1].startswith("regen"):
            # launch.<kernel>.<variant> counts every launch, .emit the
            # emissive calls' among them.
            emit = parts[3:] == ["emit"]
            name = kernel_names(parts[2], emit)[names[parts[1]]]
            out[name] = out.get(name, 0) + n
            if emit:
                plain_name = kernel_names(parts[2])[names[parts[1]]]
                out[plain_name] = out.get(plain_name, 0) - n
        elif parts[1] in names:
            out[names[parts[1]] + VARIANT_SUFFIX[parts[2]]] = n
        else:
            out[parts[1]] = n
    return {k: n for k, n in out.items() if n}


def plain_calls(wrappers):
    got = counts_since_reset()
    return {k: got[f"plain.{plain.__name__}"] for k, (_, plain) in wrappers.items()}


@contextlib.contextmanager
def plain_route(route=REGEN_ROUTE):
    """Run a gradient route (its kernels' names) through the plain versions
    on the card: the wrappers launch their kernels for every CUDA tensor,
    so the plain versions stand in for them here.  Raises unless every
    plain version of the route ran inside and no kernel launched (the
    counts are reset on entry)."""
    wrappers = grad_wrappers()
    sites = [(importlib.import_module(f"simplepathtracer_tpu_torch.ops.{WRAPPER_SITES[k][0]}"),
              WRAPPER_SITES[k][1], wrappers[k]) for k in route]
    for m, attr, (_, plain) in sites:
        setattr(m, attr, plain)
    reset_counts()
    try:
        yield
    finally:
        for m, attr, (kernel, _) in sites:
            setattr(m, attr, kernel)
    launches = launch_counts()
    calls = plain_calls(wrappers)
    if launches or not all(calls[k] for k in route):
        raise RuntimeError(f"plain route did not take the plain versions only: kernel "
                           f"launches {launches}, plain calls {calls}")


def equal_on_alive(a, b, alive):
    """Residual planes a, b ([k, n_iter, n_lanes]) bit-identical where
    ``alive``; alive and idx (float plane 9, int plane 3) everywhere, and
    under soft silhouettes the blocker index (int plane 5) too."""
    (af, ai), (bf, bi) = a, b
    ok = (torch.equal(af[:, alive], bf[:, alive]) and torch.equal(ai[:, alive], bi[:, alive])
          and torch.equal(af[9], bf[9]) and torch.equal(ai[3], bi[3]))
    if ai.shape[0] > 5:
        ok = ok and torch.equal(ai[5], bi[5])
    return ok


def dead_entries_hold(resf, resi, cnt):
    """The dead-entry contract on every (iteration, lane) of residual planes
    ([k, n_iter, n_lanes]): alive (float plane 9) is 1 below a lane's count
    ``cnt`` and 0 from it on, where idx (int plane 3) and, under soft
    silhouettes, the blocker index (int plane 5) are -1."""
    dead = torch.arange(resf.shape[1], device=cnt.device)[:, None] >= cnt.long()[None, :]
    ok = torch.equal(resf[9], (~dead).float()) and bool(((resi[3] == -1) | ~dead).all())
    if resi.shape[0] > 5:
        ok = ok and bool(((resi[5] == -1) | ~dead).all())
    return ok


def dead_store_ms(cnt, n_iter, n_planes):
    """What the re-forward's dead-entry stores cost on their own: store-only
    passes (``index_fill_``) over the dead entries (iteration >= the lane's
    count ``cnt``) of ``n_planes`` [n_iter, n_lanes] planes, in two orders.
    Lane by lane, as a one-thread-per-lane tail writes them: warp by warp,
    step s of the tail storing lane j's entry at iteration cnt[j] + s, so 32
    consecutive stores hit up to 32 rows.  Row by row: the same entries
    sorted, so 32 consecutive stores hit one row.  Both read the same
    8-byte indices.  Returns (lane-by-lane ms, row-by-row ms, dead
    entries)."""
    dev, n = cnt.device, cnt.numel()
    c = cnt.long()
    cw = torch.cat([c, c.new_full(((-n) % 32,), n_iter)]).view(-1, 32)
    lanes = torch.arange(cw.numel(), device=dev).view(-1, 32)
    row = cw[:, None, :] + torch.arange(n_iter, device=dev)[None, :, None]
    lane_order = (row * n + lanes[:, None, :])[row < n_iter]
    del row
    row_order = lane_order.sort().values
    planes = torch.empty((n_planes, n_iter * n), dtype=torch.float32, device=dev)

    def fill(idx):
        for k in range(n_planes):
            planes[k].index_fill_(0, idx, 0.0)

    out = (cuda_ms(lambda: fill(lane_order), reps=2), cuda_ms(lambda: fill(row_order), reps=2),
           lane_order.numel())
    del planes, lane_order, row_order
    return out


def normwise_err(got, want):
    """max|got - want| / max|want| (0 when both are 0)."""
    d = (got - want).abs().max().item()
    m = want.abs().max().item()
    return d / m if m > 0 else d, d


def grads_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Every leaf within |d| <= atol + rtol |want|; (ok, max |d|)."""
    ok, worst = True, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        worst = max(worst, d.max().item())
        ok = ok and bool((d <= atol + rtol * w.abs()).all()) and bool(torch.isfinite(g).all())
    return ok, worst


def bucket_rows(c, idx, s):
    """The rows of a bucket call whose index names a sphere: (index [n]
    int64, cotangents [n, K] f32)."""
    flat = idx.reshape(-1)
    keep = (flat >= 0) & (flat < s)
    return flat[keep].to(torch.int64), c.reshape(c.shape[0], -1)[:, keep].T.contiguous()


def bucket_errors(d_k, d_p, idx_keep, src, s):
    """|d| of the kernel's table ``d_k`` and of the float32 index_add_
    ``d_p`` against a float64 index_add_ of the same rows, the bound each
    entry of the kernel's keeps (BUCKET_* above), and the table's max."""
    ref = torch.zeros((s, src.shape[1]), dtype=torch.float64, device=src.device)
    ref.index_add_(0, idx_keep, src.double())
    mag = torch.zeros_like(ref).index_add_(0, idx_keep, src.abs().double())
    tol = (BUCKET_RTOL * ref.abs() + BUCKET_ATOL_REL * src.abs().max().double()
           + BUCKET_SUM_ROUNDINGS * F32_EPS * mag)
    return (d_k.double() - ref).abs(), (d_p.double() - ref).abs(), tol, ref.abs().max().item()


def key_coherence(idx, s):
    """How the bucket's keys fall in groups of 32 consecutive rows (as a
    warp reads them), counting only rows that name a sphere, over the
    groups that hold one: the share of groups with one distinct key, the
    mean count of distinct keys per group, and the busiest slot's share of
    the rows."""
    flat = idx.reshape(-1)
    g = torch.cat([flat, flat.new_full(((-flat.numel()) % 32,), -1)]).view(-1, 32)
    live = (g >= 0) & (g < s)
    keep = live.any(dim=1)
    g, live = g[keep], live[keep]
    srt = torch.where(live, g, torch.full_like(g, s)).sort(dim=1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = (new & (srt < s)).sum(dim=1).float()
    counts = torch.bincount(flat[(flat >= 0) & (flat < s)].long(), minlength=s)
    return dict(groups=int(keep.sum().item()), one_key_share=(distinct == 1).float().mean().item(),
                mean_distinct_keys=distinct.mean().item(),
                busiest_share=counts.max().item() / max(1, counts.sum().item()),
                busiest_slot=int(counts.argmax().item()))


def loss_and_grads(tpt, scene, target, cam, cfg, key, dev, pixel_perm=None, leaves=None):
    """pixel_loss and its gradient in every leaf, or in ``leaves`` only."""
    params, _ = tpt.split_params(scene) if leaves is None else tpt.split_params(scene, leaves)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = tpt.pixel_loss(params, scene, target, cam, cfg, key, pixel_perm=pixel_perm, device=dev)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def phase5_kernels(tpt, dev):
    """The gradient kernels against their plain versions at small shapes,
    hard and with soft silhouettes.  Returns ({kernel: max |d| seen},
    {kernel: plain ms}, {kernel: kernel ms}, {kernel: the shape of those
    two times}: the cover cases, and the soft plane case for the soft plane
    instantiations)."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    trio_cam = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)

    def cover():
        return tpt.compact_scene(tpt.cover_scene(0, device=dev)), tpt.PRESETS["cover"].camera_fn(dev)

    def trio_plane():
        return (tpt.with_ground_plane(tpt.three_sphere_scene(device=dev)),
                tpt.make_camera(**trio_cam, device=dev))

    def reference():
        return (tpt.reference_scene(device=dev),
                tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev))

    cases = [
        # name, scene and camera, w, h, spp, depth, rr, softness, spp_chunk
        # of the pixel_loss check (the soft plane case is the combined case
        # of tests/test_pallas_grad_regen.py:590: plane, soft, RR, stream)
        ("cover", cover, 64, 32, 4, 5, 0, 0.0, 2),
        ("three_sphere_plane", trio_plane, 48, 24, 8, 5, 2, 0.0, 4),
        ("reference_37x13", reference, 37, 13, 4, 5, 0, 0.0, 2),
        ("cover_soft", cover, 64, 32, 4, 5, 0, 0.05, 2),
        ("three_sphere_plane_soft", trio_plane, 48, 24, 8, 5, 2, 0.05, 2),
        # The soft instantiations with SIL_FRESNEL on (the backward adds
        # the Schlick-coin ratio's score; no forward value changes), at half
        # the width and height (the plane case at half the spp): the plain
        # versions' time.
        ("cover_soft_fresnel", cover, 32, 16, 4, 5, 0, 0.05, 2),
        ("three_sphere_plane_soft_fresnel", trio_plane, 24, 12, 4, 5, 2, 0.05, 2),
    ]
    errs = {name: 0.0 for name, _, _ in GRAD_KERNELS + SOFT_KERNELS + SOFT_PLANE_KERNELS}
    plain_ms, kernel_ms, shapes = {}, {}, {}
    gen = torch.Generator().manual_seed(1)
    key = tpt.make_key(3)
    lap()
    for name, build, w, h, spp, depth, rr, softness, chunk in cases:
        with sil_fresnel(name.endswith("_fresnel")):
            phase5_case(tpt, dev, gr, bucket, errs, plain_ms, kernel_ms, shapes, gen, key,
                        name, build, w, h, spp, depth, rr, softness, chunk)
        lap(f"phase5 {name}")
    return errs, plain_ms, kernel_ms, shapes


def phase5_case(tpt, dev, gr, bucket, errs, plain_ms, kernel_ms, shapes, gen, key,
                name, build, w, h, spp, depth, rr, softness, chunk):
    """One case of phase 5 (the gradient kernels against their plain
    versions), with the SIL_FRESNEL switch as it stands."""
    scene, cam = build()
    soft = softness > 0.0
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr,
                           silhouette_softness=softness)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    pix = torch.arange(w * h, device=dev)
    call = gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key, pix,
                         n_samples=spp, max_depth=depth, width=w, height=h,
                         rr_start_depth=rr, softness=softness)
    kn = kernel_names(gr.variant(call))
    tag = (f"phase5 {name} {w}x{h} spp={spp} depth={depth} rr={rr} soft={softness} "
           f"fresnel={gr.fresnel_on(call)}")

    # Recording forward, both modes: bit-exact.
    rad_k, cnt_k, res_k = gr.regen_forward(call, 0, True)
    sync(dev)
    rad_p, cnt_p, res_p = gr.regen_fwd_reference(call, 0, True)
    alive = res_p[0][9] > 0
    full_ok = (torch.equal(rad_k, rad_p) and torch.equal(cnt_k, cnt_p)
               and equal_on_alive(res_k, res_p, alive))
    radi_k, cnti_k, pk_k = gr.regen_forward(call, 0, False)
    sync(dev)
    radi_p, cnti_p, pk_p = gr.regen_fwd_reference(call, 0, False)
    idx_ok = (torch.equal(radi_k, radi_p) and torch.equal(cnti_k, cnti_p)
              and torch.equal(pk_k, pk_p) and torch.equal(radi_k, rad_k))
    errs[kn["regen_fwd"]] = max(errs[kn["regen_fwd"]], (rad_k - rad_p).abs().max().item(),
                                (radi_k - radi_p).abs().max().item())
    extra = ""
    if soft:
        idx = res_p[1][3]
        extra = (f", blockers {(res_p[1][5][alive] >= 0).sum().item()}, crossing-loser "
                 f"plane wins {(idx[alive] == gr.PLANE_CROSS_IDX).sum().item()}")
    print(f"{tag}: regen fwd full {'bit-exact' if full_ok else 'DIFFERS'}, idx-only "
          f"{'bit-exact' if idx_ok else 'DIFFERS'} (n_iter={call.n_iter}, "
          f"iterations={cnt_k.sum().item():.0f}, alive entries={alive.sum().item()}{extra})")
    if not (full_ok and idx_ok):
        raise RuntimeError(f"{tag}: regen forward kernel disagrees with its plain version")

    # Scan-free re-forward from the kernel's packed words: the planes of
    # the recording forward, bit for bit.
    res_r = gr.regen_refwd(call, 0, pk_k)
    sync(dev)
    refwd_ok = equal_on_alive(res_r, res_k, alive)
    res_rp = gr.regen_refwd_reference(call, 0, pk_k)
    refwd_ok = refwd_ok and equal_on_alive(res_rp, res_k, alive)
    errs[kn["regen_refwd"]] = max(errs[kn["regen_refwd"]],
                                  (res_r[0][:, alive] - res_k[0][:, alive]).abs().max().item())
    print(f"{tag}: re-forward planes {'bit-exact' if refwd_ok else 'DIFFER'} on alive entries")
    if not refwd_ok:
        raise RuntimeError(f"{tag}: re-forward kernel disagrees with the recording forward")

    # Backward over the same residuals: expected bit-exact.
    ct = torch.randn((w * h, 3), generator=gen).to(dev) * 1e-3
    ctp_k, part_k = gr.regen_backward(call, 0, res_k[0], res_k[1], ct)
    sync(dev)
    ctp_p, part_p = gr.regen_bwd_reference(call, 0, res_k[0], res_k[1], ct)
    (e1, d1), (e2, d2) = normwise_err(ctp_k, ctp_p), normwise_err(part_k, part_p)
    errs[kn["regen_bwd"]] = max(errs[kn["regen_bwd"]], d1, d2)
    print(f"{tag}: backward cotangent planes rel {e1:.3e} (max|d| {d1:.3e}), "
          f"partials rel {e2:.3e} (max|d| {d2:.3e})")
    if not (e1 <= BWD_RTOL and e2 <= BWD_RTOL and torch.isfinite(ctp_k).all()):
        raise RuntimeError(f"{tag}: backward kernel disagrees with its plain version")

    # Buckets against index_add_: the winners' 9 columns; soft, the
    # blockers' 4 by blocker index.
    s = call.n_spheres
    cols = [("bucket", ctp_k[:9], res_k[1][3])]
    if soft:
        cols.append(("bucket_blocker", ctp_k[9:], res_k[1][5]))
    for bname, c, idx in cols:
        d_k = bucket.bucket_cols(c, idx, s)
        sync(dev)
        d_p = bucket.bucket_cols_reference(c, idx, s)
        err_k, err_p, tol, top = bucket_errors(d_k, d_p, *bucket_rows(c, idx, s), s)
        errs[bname] = max(errs[bname], err_k.max().item())
        print(f"{tag}: {bname} ({c.shape[0]} columns) against float64 index_add_: max|d| "
              f"{err_k.max().item():.3e}, max |d| / tol {(err_k / tol).max().item():.3f} "
              f"(float32 index_add_ {err_p.max().item():.3e}, "
              f"{(err_p / tol).max().item():.3f}); table max {top:.3e}")
        if not bool((err_k <= tol).all()):
            raise RuntimeError(f"{tag}: {bname} kernel disagrees with index_add_")

    # pixel_loss through the kernels against the plain route, streamed
    # over several chunks.
    gcfg = cfg.replace(use_pallas_grad=True, grad_regen=True, spp_chunk=chunk)
    target = torch.full((h, w, 3), 0.25, device=dev)
    l_k, g_k = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
    with plain_route():
        l_p, g_p = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
    ok, worst = grads_close(list(g_k.values()), list(g_p.values()))
    rel = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    print(f"{tag}: pixel_loss kernels {l_k.item():.9g} plain {l_p.item():.9g} (rel {rel:.2e}), "
          f"gradients max|d| {worst:.3e} over {len(g_k)} leaves, {spp // chunk} chunks")
    if not (ok and rel <= 1e-6):
        raise RuntimeError(f"{tag}: pixel_loss through the kernels disagrees with the plain route")

    if name in ("cover", "cover_soft", "three_sphere_plane_soft") and dev.type == "cuda":
        shape = f"{name} {w}x{h}x{spp}spp depth {depth} rr {rr} soft {softness}"
        bwd_args = (call, 0, res_k[0], res_k[1], ct)
        timed = [
            (kn["regen_fwd"], gr.regen_forward, gr.regen_fwd_reference, (call, 0, False)),
            (kn["regen_refwd"], gr.regen_refwd, gr.regen_refwd_reference, (call, 0, pk_k)),
            (kn["regen_bwd"], gr.regen_backward, gr.regen_bwd_reference, bwd_args),
        ]
        if name != "three_sphere_plane_soft":
            for bname, c, idx in cols[-1:]:
                timed.append((bname, bucket.bucket_cols, bucket.bucket_cols_reference,
                              (c, idx, s)))
        for kname, kern, plain, args in timed:
            plain_ms[kname] = cuda_ms(lambda: plain(*args), reps=1, warm=False)
            kernel_ms[kname] = cuda_ms(lambda: kern(*args), reps=10)
            shapes[kname] = shape
            print(f"phase5 {shape}: {kname} plain {plain_ms[kname]:.3f} ms, kernel "
                  f"{kernel_ms[kname]:.3f} ms")


def phase6_main(tpt, dev, scene, cam, cfg, key, persistent_sums, persistent_counts, wrappers):
    """The gradient path at the main path's shapes: kernels against the
    plain route on random pixels, the regen forward against the persistent
    kernel's full frame, a full-frame gradient, and ``fit``.  Returns what
    the report needs."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr
    from simplepathtracer_tpu_torch.ops.persistent import render_block_persistent
    from simplepathtracer_tpu_torch.render import _persistent_args
    from simplepathtracer_tpu_torch.routes import stream_capacity_spp

    out = {"errs": {}}
    gcfg = tpt.grad_safe_config(cfg, dev)
    chunk = gcfg.spp_chunk or cfg.spp
    n_chunks = cfg.spp // chunk
    cap = stream_capacity_spp(gcfg, scene)
    print(f"phase6 route: regen={gcfg.use_pallas_grad and gcfg.grad_regen}, spp_chunk={chunk}, "
          f"chunks={n_chunks}, streamed-idx capacity {cap} spp")
    if not (gcfg.grad_regen and n_chunks > 1 and cap >= cfg.spp and cfg.spp % chunk == 0):
        raise RuntimeError("phase6: the main path does not take the streamed-idx route")
    out.update(chunk=chunk, n_chunks=n_chunks)

    # The target is the true scene's render; the fit starts from dimmed
    # albedo and sky.
    target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 1000))
    start = scene.replace(albedo=scene.albedo * ALBEDO_START,
                          sky_lo=scene.sky_lo * SKY_START, sky_hi=scene.sky_hi * SKY_START)

    # (a) Gradients on random pixels of the full frame: kernels against the
    # plain versions on the card, same key and chunking, over CHECK_CHUNKS
    # chunks (the streamed route: idx-only forward, re-forward per chunk).
    gen = torch.Generator().manual_seed(2)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    cfg_a = cfg.replace(spp=CHECK_CHUNKS * CHECK_SPP_CHUNK, spp_chunk=CHECK_SPP_CHUNK,
                        max_depth=CHECK_DEPTH)
    t0 = time.perf_counter()
    l_k, g_k = loss_and_grads(tpt, start, target, cam, cfg_a, key, dev, pixel_perm=rows)
    sync(dev)
    t1 = time.perf_counter()
    with plain_route():
        l_p, g_p = loss_and_grads(tpt, start, target, cam, cfg_a, key, dev, pixel_perm=rows)
    sync(dev)
    t2 = time.perf_counter()
    ok, worst = grads_close(list(g_k.values()), list(g_p.values()))
    print(f"phase6 {N_CHECK_PIXELS} random pixels, {cfg_a.spp} spp in {CHECK_CHUNKS} chunks, depth "
          f"{CHECK_DEPTH}: loss kernels "
          f"{l_k.item():.9g} plain {l_p.item():.9g}, gradients max|d| {worst:.3e} "
          f"(kernels {t1 - t0:.2f} s, plain {t2 - t1:.2f} s)")
    if not (torch.equal(l_k, l_p) and ok):
        raise RuntimeError("phase6: pixel_loss through the kernels disagrees with the plain route")
    out["errs"]["grad_random_pixels"] = worst
    lap("phase6 (a) random pixels against the plain route")

    # (b) Regen forward over the full frame against the persistent kernel.
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)

    def regen_call(n_samples):
        return gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key, pix,
                             n_samples=n_samples, max_depth=cfg.max_depth, width=cfg.width,
                             height=cfg.height, t_min=cfg.t_min, t_max=cfg.t_max,
                             rr_start_depth=cfg.rr_start_depth)

    pargs = _persistent_args(scene, cam, cfg)

    def persistent(sample_offset, n_samples):
        return render_block_persistent(pix, *pargs, key, sample_offset, n_samples, cfg.max_depth,
                                       cfg.width, cfg.height, t_min=cfg.t_min, t_max=cfg.t_max,
                                       rr_start_depth=cfg.rr_start_depth, return_counts=True)

    out["errs"]["regen_vs_persistent"] = knife_edge(
        gr, regen_call, persistent, cfg, chunk, persistent_sums, persistent_counts)
    lap("phase6 (b) regen forward against the persistent kernel")

    # (c) One full-frame gradient: every leaf finite and nonzero.
    reset_peak(dev)
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(tpt, start, target, cam, cfg, key, dev)
    sync(dev)
    out["grad_s"] = time.perf_counter() - t0
    out["grad_peak_gb"] = peak_gb(dev)
    lap("phase6 (c) full-frame gradient")
    summary = {k: f"{g.abs().max().item():.3e}" for k, g in grads.items()}
    print(f"phase6 full-frame gradient: loss {loss.item():.6g}, {out['grad_s']:.3f} s, peak "
          f"{out['grad_peak_gb']:.2f} GB, max|grad| per leaf {summary}")
    for k, g in grads.items():
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise RuntimeError(f"phase6: gradient of {k} is not finite or is zero")

    # (d) fit: one warm step, then FIT_STEPS timed steps through the kernels
    # only; centers and radii frozen.
    mask = {"centers": torch.zeros_like(scene.centers), "radii": torch.zeros_like(scene.radii)}
    fit_kw = dict(lr=FIT_LR, softness=0.0, param_mask=mask, device=dev)
    tpt.fit(start, target, cam, cfg, key, steps=1, **fit_kw)
    sync(dev)
    lap("phase6 (d) warm fit step")
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit(start, target, cam, cfg, key, steps=FIT_STEPS, **fit_kw)
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / FIT_STEPS
    out["fit_peak_gb"] = peak_gb(dev)
    out["launches"] = launch_counts()
    out["plain_calls"] = plain_calls(wrappers)
    out["losses"] = losses
    err_alb = (fitted.albedo - scene.albedo).abs().mean().item()
    err_alb0 = (start.albedo - scene.albedo).abs().mean().item()
    print(f"phase6 fit {FIT_STEPS} steps (lr {FIT_LR}): losses {losses}, {out['step_s']:.3f} s/step, "
          f"{cfg.num_pixels * cfg.spp / out['step_s'] / 1e6:.2f} Mpaths/s fwd+bwd, peak "
          f"{out['fit_peak_gb']:.2f} GB, mean|albedo - truth| {err_alb0:.4f} -> {err_alb:.4f}, "
          f"launches {out['launches']}, plain calls {out['plain_calls']}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise RuntimeError("phase6: the fit's loss did not fall")
    lap("phase6 (d) fit")

    # (e) Each kernel at the main path's chunk shape: against its plain
    # version on the random pixels of (a), timed, and bounded.
    if dev.type == "cuda":
        out.update(full_width_kernels(gr, bucket, regen_call(chunk), scene, cfg, rows))
    lap("phase6 (e) kernels at full width")
    return out


def knife_edge(gr, regen_call, persistent, cfg, chunk, persistent_sums, persistent_counts):
    """The regen forward against the persistent kernel over the full frame,
    at KNIFE_EDGE_SPP and at the main path's spp in its chunks; returns
    max |d| of the latter.

    The two rebuild the hit normal in different ops (bounce_tile's 1/sqrt,
    the persistent kernel's rsqrt), so a path at a silhouette may take
    another turn, and one such path among a pixel's samples moves its mean
    past 1e-4.  To show that this is the whole cause, every sample also
    runs alone through both kernels: a path is flipped where its radiance
    differs by more than FLIP_TOL in a channel or its bounce count differs.
    Raises unless: the per-sample runs sum to the multi-sample frames; the
    8-spp frame is inside the repo's knife-edge bound
    (tests/test_pallas_bounce.py:44-46) and the full-spp frame inside its
    depth-10 regen bound (tests/test_pallas_grad_regen.py:215-216); every
    channel off by more than 1e-4 lies on a pixel with a flipped path; and
    the flipped paths of the first KNIFE_EDGE_SPP samples are as many as
    the rate over all samples predicts (5 sigma, Poisson)."""
    spp, p = cfg.spp, cfg.num_pixels
    sums_k = torch.zeros_like(persistent_sums)
    cnt_k = torch.zeros_like(persistent_counts)
    call = regen_call(chunk)
    for off in range(0, spp, chunk):
        r, c, _ = gr.regen_forward(call, off, False)
        sums_k += r
        cnt_k += c
    sums8_k, cnt8_k, _ = gr.regen_forward(regen_call(KNIFE_EDGE_SPP), 0, False)
    sums8_q, cnt8_q = persistent(0, KNIFE_EDGE_SPP)

    call1 = regen_call(1)
    flips = []
    flipped = torch.zeros(p, dtype=torch.bool, device=persistent_sums.device)
    edges = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
    hist = torch.zeros(len(edges), dtype=torch.int64, device=flipped.device)
    one_k, one_q = torch.zeros_like(sums_k), torch.zeros_like(sums_k)
    one_ck, one_cq = torch.zeros_like(cnt_k), torch.zeros_like(cnt_k)
    for s in range(spp):
        r_k, c_k, _ = gr.regen_forward(call1, s, False)
        r_q, c_q = persistent(s, 1)
        d = (r_k - r_q).abs().amax(dim=1)
        f = (d > FLIP_TOL) | (c_k != c_q)
        flips.append(f.sum())
        flipped |= f
        if s + 1 == KNIFE_EDGE_SPP:
            flipped8 = flipped.clone()
        hist += torch.stack([(d > e).sum() for e in edges])
        one_k += r_k
        one_q += r_q
        one_ck += c_k
        one_cq += c_q
    flips = torch.stack(flips).double().cpu()

    def decomposes(one, full):
        return bool(((one - full).abs() <= 1e-4 * (full.abs() + 1.0)).all())

    sums_ok = (decomposes(one_k, sums_k) and decomposes(one_q, persistent_sums)
               and torch.equal(one_ck, cnt_k) and torch.equal(one_cq, persistent_counts))

    def frame(sums_a, sums_b, cnt_a, cnt_b, n, flip_pix):
        d = ((sums_a - sums_b) / n).abs()
        over = d > 1e-4
        unequal = cnt_a != cnt_b
        return dict(mean=d.mean().item(), share=over.float().mean().item(),
                    share2=(d > 1e-2).float().mean().item(), max=d.max().item(),
                    unexplained=(over & ~flip_pix[:, None]).sum().item(),
                    over_on_unequal=(over & unequal[:, None]).sum().item() / max(1, over.sum().item()),
                    unequal_pix=unequal.float().mean().item(),
                    flip_pix=flip_pix.float().mean().item())

    f8 = frame(sums8_k, sums8_q, cnt8_k, cnt8_q, KNIFE_EDGE_SPP, flipped8)
    fa = frame(sums_k, persistent_sums, cnt_k, persistent_counts, spp, flipped)
    rate = flips.sum().item() / (spp * p)
    expect8 = flips.sum().item() * KNIFE_EDGE_SPP / spp
    got8 = flips[:KNIFE_EDGE_SPP].sum().item()
    rate_ok = abs(got8 - expect8) <= 5.0 * math.sqrt(expect8) + 1.0
    for n, f in ((KNIFE_EDGE_SPP, f8), (spp, fa)):
        print(f"phase6 regen forward vs persistent kernel, full frame at {n} spp: mean|d| "
              f"{f['mean']:.3e}, share |d| > 1e-4 {f['share']:.5f}, share |d| > 1e-2 "
              f"{f['share2']:.6f}, max|d| {f['max']:.3e}; pixels with a flipped path "
              f"{f['flip_pix']:.5f} (1 - (1 - rate)^spp = {1 - (1 - rate) ** n:.5f}), channels over "
              f"1e-4 off those pixels {f['unexplained']}; pixels with unequal counts "
              f"{f['unequal_pix']:.5f}, share of the channels over 1e-4 on them "
              f"{f['over_on_unequal']:.3f}")
    print(f"phase6 per-sample paths: flipped per sample mean {flips.mean().item():.1f} (rate "
          f"{rate:.3e} of paths), first {KNIFE_EDGE_SPP} samples {got8:.0f} against {expect8:.1f} "
          f"expected, min/max per sample {flips.min().item():.0f}/{flips.max().item():.0f}; paths "
          f"with max-channel |d| over {dict(zip(edges, hist.tolist()))}; per-sample runs sum to "
          f"the frames: {sums_ok}")
    if not (sums_ok and torch.isfinite(sums_k).all() and f8["mean"] < 1e-4
            and f8["share"] < KNIFE_EDGE_SHARE and fa["mean"] < 1e-4 and fa["share2"] < 1e-3
            and f8["unexplained"] == 0 and fa["unexplained"] == 0 and rate_ok):
        raise RuntimeError("phase6: regen forward disagrees with the persistent kernel")
    return fa["max"]


def timed_plain(fn, *args):
    """(fn(*args), its wall ms on the card): a plain version's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def full_width_kernels(gr, bucket, call, scene, cfg, rows):
    """Each gradient kernel at a main path's chunk shape (the scene's tables,
    the chunk at sample offset 0; the instantiation ``call`` selects: hard,
    soft, or soft with a plane, each with or without an emission table).
    With one bank, lane = pixel and a lane's outputs depend on its pixel
    alone, so the kernels' outputs on the lanes ``rows`` must equal the
    plain versions run on those pixels (same key and sample offset): the
    forward in both modes, the re-forward and the backward.  The buckets'
    tables over all the chunk's rows are held against a float64
    index_add_.  Also the CUDA-event ms of each kernel, its bound from this
    run's data (an emissive forward's also by its RNG, as phase 4e bounds
    it), the plain versions' wall ms on the lanes, index_add_'s time on
    each bucket's rows, and the chunk's winner codes from the full-residual
    forward (plane hits, crossing-loser plane wins, blockers).  Raises on a
    mismatch."""
    from simplepathtracer_tpu_torch import tracing

    if call.n_banks != 1:
        raise RuntimeError("full_width_kernels needs one bank (lane = pixel)")
    soft = call.softness > 0.0
    emit = call.emit is not None
    kn = kernel_names(gr.variant(call), emit)
    n_res = N_RES_PLANES_SOFT if soft else N_RES_PLANES
    n_ct = gr._n_planes(call)[2]
    b, n, p = call.n_iter, call.n_lanes, cfg.num_pixels
    sub = call._replace(pixel_ids=rows.to(torch.int32), n_lanes=rows.numel())
    cols = rows.to(torch.int64)
    errs, plain_ms = {}, {}
    tag = (f"kernel at {cfg.width}x{cfg.height}x{call.n_samples}spp{' soft' if soft else ''}"
           f"{' emissive' if emit else ''}, {rows.numel()} random lanes:")
    live = ((scene.radii.abs() > 1e-3) & (scene.centers[:, 1] > -1e6)).sum().item()
    ms, bound, res = {}, {}, {}
    # Timed launches per kernel: 10x more on a chunk of a few million
    # entries (the plane fit's), whose kernels take well under a ms.
    more = 1 if b * n > 5e7 else 10

    # Full-residual mode: the planes on the random lanes, and the winner
    # codes of the whole chunk.
    rad_f, cnt_f, (resf_f, resi_f) = gr.regen_forward(call, 0, True)
    (rad_fp, cnt_fp, res_fp), plain_ms[kn["regen_fwd"]] = timed_plain(
        gr.regen_fwd_reference, sub, 0, True)
    ok = (torch.equal(rad_f[cols], rad_fp) and torch.equal(cnt_f[cols], cnt_fp)
          and equal_on_alive((resf_f[:, :, cols], resi_f[:, :, cols]), res_fp, res_fp[0][9] > 0))
    errs[kn["regen_fwd"]] = (rad_f[cols] - rad_fp).abs().max().item()
    dead_ok = dead_entries_hold(resf_f, resi_f, cnt_f)
    print(f"{tag} regen fwd (full residuals) dead-entry contract on all {b} x {n} entries "
          f"{'holds' if dead_ok else 'BROKEN'}")
    if not dead_ok:
        raise RuntimeError("full width: regen forward kernel (full residuals) breaks the "
                           "dead-entry contract")
    idx_f = resi_f[3]
    res["codes"] = dict(plane=gr.is_plane(idx_f).sum().item(),
                        crossing_loser=(idx_f == gr.PLANE_CROSS_IDX).sum().item(),
                        blockers=(resi_f[gr._I_BLK] >= 0).sum().item() if soft else 0)
    print(f"{tag} regen fwd (full residuals) radiance, counts and planes "
          f"{'bit-exact' if ok else 'DIFFER'}; chunk winner codes {res['codes']}")
    if not ok:
        raise RuntimeError("full width: regen forward kernel (full residuals) disagrees "
                           "with its plain version")
    del resf_f, resi_f, idx_f, res_fp

    ms[kn["regen_fwd"]] = cuda_ms(lambda: gr.regen_forward(call, 0, False), reps=2 * more)
    with tracing.enabled(), tracing.span("chip_smoke.regen_forward"):
        rad, cnt, packed = gr.regen_forward(call, 0, False)
    res["lane_share"] = sh = lane_shares(cnt, tracing.spans()[0]["counts"])
    print(f"{tag} regen fwd lanes: live-lane share {sh['fixed_map']:.4f} on the fixed map (one "
          f"thread per lane), {sh['fetch']:.4f} on the lane fetch (lane-iterations "
          f"{sh['lane_iterations']:.0f} / thread-iterations {sh['thread_iterations']}); resident "
          f"grid {sh['grid_blocks']} blocks x 128 threads for {n} lanes")
    rad_p, cnt_p, packed_p = gr.regen_fwd_reference(sub, 0, False)
    ok = (torch.equal(rad[cols], rad_p) and torch.equal(cnt[cols], cnt_p)
          and torch.equal(packed[..., cols], packed_p)
          and torch.equal(rad, rad_f) and torch.equal(cnt, cnt_f))
    errs[kn["regen_fwd"]] = max(errs[kn["regen_fwd"]], (rad[cols] - rad_p).abs().max().item())
    print(f"{tag} regen fwd (idx-only) radiance, counts and packed words "
          f"{'bit-exact' if ok else 'DIFFER'} (and equal to the full-residual mode's)")
    if not ok:
        raise RuntimeError("full width: regen forward kernel disagrees with its plain version")
    del rad_f, cnt_f
    res["full_ms"] = cuda_ms(lambda: gr.regen_forward(call, 0, True), reps=more)
    print(f"{tag} regen fwd (full residuals) {res['full_ms']:.3f} ms")
    iters = cnt.double().sum().item()
    res.update(iters_chunk=iters, n_iter=b, n_lanes=n)
    # Sphere tests; the packed words and sums are a few hundred MB.
    flops = FLOPS_PER_SOFT_SPHERE_TEST if soft else FLOPS_PER_SPHERE_TEST
    ops = iters * live * flops
    nbytes = packed.numel() * 4 + p * (4 + 12)
    bound[kn["regen_fwd"]] = (ops / PEAK_FP32, nbytes / PEAK_BYTES)
    if emit:
        # On 8 spheres the threefry work outweighs the scan: at most 2
        # evaluations a path and 4 a segment (phase 4e's count).
        paths = n * call.n_samples
        rng_s = (2 * paths + 4 * iters) * THREEFRY_INT_OPS / PEAK_INT32
        bound[kn["regen_fwd"]] = (max(ops / PEAK_FP32, rng_s), nbytes / PEAK_BYTES)
    del rad

    ms[kn["regen_refwd"]] = cuda_ms(lambda: gr.regen_refwd(call, 0, packed), reps=2 * more)
    resf, resi = gr.regen_refwd(call, 0, packed)
    (resf_p, resi_p), plain_ms[kn["regen_refwd"]] = timed_plain(
        gr.regen_refwd_reference, sub, 0, packed_p)
    alive = resf_p[9] > 0
    ok = equal_on_alive((resf[:, :, cols], resi[:, :, cols]), (resf_p, resi_p), alive)
    errs[kn["regen_refwd"]] = (resf[:, :, cols][:, alive] - resf_p[:, alive]).abs().max().item()
    extra = ""
    if soft:
        idx_a = resi_p[3][alive]
        extra = (f"; blockers {(resi_p[5][alive] >= 0).sum().item()}, crossing-loser plane "
                 f"wins {(idx_a == gr.PLANE_CROSS_IDX).sum().item()}")
    dead_ok = dead_entries_hold(resf, resi, cnt)
    print(f"{tag} re-forward planes {'bit-exact' if ok else 'DIFFER'} on "
          f"{alive.sum().item()} alive entries{extra}; dead-entry contract on all {b} x {n} "
          f"entries {'holds' if dead_ok else 'BROKEN'}")
    if not ok:
        raise RuntimeError("full width: re-forward kernel disagrees with its plain version")
    if not dead_ok:
        raise RuntimeError("full width: re-forward kernel breaks the dead-entry contract")
    # What its dead entries' stores cost alone, in a one-thread-per-lane
    # tail's order and row by row.
    n_dead_planes = 3 if soft else 2
    lane_ms, row_ms, n_dead = dead_store_ms(cnt, b, n_dead_planes)
    res["dead_store"] = dict(entries=n_dead, planes=n_dead_planes, lane_by_lane_ms=lane_ms,
                             row_by_row_ms=row_ms)
    print(f"{tag} re-forward dead entries {n_dead} of {b * n} ({n_dead / (b * n):.4f}): "
          f"store-only pass over the {n_dead_planes} dead-triple planes lane by lane (a "
          f"one-thread-per-lane tail's order) {lane_ms:.3f} ms, row by row {row_ms:.3f} ms")
    del cnt
    # Reads the packed words; writes the planes on live entries, alive and
    # idx (soft: and bidx) on the rest.
    dead = 12 if soft else 8
    nbytes = packed.numel() * 4 + iters * n_res * 4 + (b * n - iters) * dead
    bound[kn["regen_refwd"]] = (0.0, nbytes / PEAK_BYTES)
    del packed

    gen = torch.Generator().manual_seed(3)
    ct = (torch.randn((p, 3), generator=gen) * 1e-6).to(call.pixel_ids.device)
    ms[kn["regen_bwd"]] = cuda_ms(lambda: gr.regen_backward(call, 0, resf, resi, ct), reps=2 * more)
    if soft and not emit:
        # The same launch with SIL_FRESNEL on, between two more with it off
        # (the switch is a runtime flag of the constants).
        call_f = fresnel_call(call)
        on = cuda_ms(lambda: gr.regen_backward(call_f, 0, resf, resi, ct), reps=2 * more)
        off = cuda_ms(lambda: gr.regen_backward(call, 0, resf, resi, ct), reps=2 * more)
        res["fresnel_ms"] = {kn["regen_bwd"]: {"off": ms[kn["regen_bwd"]], "on": on,
                                              "off_again": off}}
        print(f"{tag} backward with SIL_FRESNEL off {ms[kn['regen_bwd']]:.3f} ms, on "
              f"{on:.3f} ms, off again {off:.3f} ms")
    ct_planes, part = gr.regen_backward(call, 0, resf, resi, ct)
    # What the backward's schedule meets: the warps' live share (one thread
    # per lane, each warp walking back from its longest lane's count), and
    # the time of a store-only pass over its cotangent planes.
    share = warp_live_share((resf[9] > 0).sum(dim=0))
    store_ms = cuda_ms(lambda: ct_planes.zero_(), reps=2 * more)
    print(f"{tag} backward: warp live share {share:.4f} (live lane-iterations over 32 x the "
          f"warps' longest counts), store-only pass over the {n_ct} cotangent planes "
          f"{store_ms:.3f} ms")
    ct_planes, part = gr.regen_backward(call, 0, resf, resi, ct)
    (ct_p, part_p), plain_ms[kn["regen_bwd"]] = timed_plain(
        gr.regen_bwd_reference, sub, 0, resf_p, resi_p, ct[cols])
    (e1, d1), (e2, d2) = normwise_err(ct_planes[:, :, cols], ct_p), normwise_err(part[:, cols], part_p)
    errs[kn["regen_bwd"]] = max(d1, d2)
    print(f"{tag} backward cotangent planes rel {e1:.3e} (max|d| {d1:.3e}), partials rel "
          f"{e2:.3e} (max|d| {d2:.3e})")
    if not (e1 <= BWD_RTOL and e2 <= BWD_RTOL and torch.isfinite(ct_planes).all()):
        raise RuntimeError("full width: backward kernel disagrees with its plain version")
    # Reads the planes on live entries and alive on the rest; writes the
    # cotangent planes whole.
    nbytes = iters * n_res * 4 + (b * n - iters) * 4 + b * n * n_ct * 4
    bwd_ops = BWD_OPS_PER_ITER_SOFT if soft else BWD_OPS_PER_ITER
    bound[kn["regen_bwd"]] = (iters * bwd_ops / PEAK_FP32, nbytes / PEAK_BYTES)
    del resf, part, resf_p, resi_p

    s = call.n_spheres
    n_win = 12 if emit else 9
    buckets = [(kn["bucket"], ct_planes[:n_win], resi[3])]
    if soft:
        buckets.append(("bucket_blocker", ct_planes[n_win:], resi[5]))
    res["library_ms"], res["bucket_rows"], res["coherence"] = {}, {}, {}
    for bname, c, idx in buckets:
        k = c.shape[0]
        res["coherence"][bname] = coh = key_coherence(idx, s)
        print(f"{tag} {bname} key coherence over groups of 32 rows: {json.dumps(coh)}")
        ms[bname] = cuda_ms(lambda: bucket.bucket_cols(c, idx, s), reps=3 * more)
        d_k = bucket.bucket_cols(c, idx, s)
        idx_keep, src = bucket_rows(c, idx, s)
        n_rows = idx_keep.numel()
        # Reads every index and the k cotangents of the rows that name a sphere.
        bound[bname] = (n_rows * k / PEAK_FP32, (idx.numel() * 4 + n_rows * k * 4) / PEAK_BYTES)
        table = torch.zeros((s, k), dtype=torch.float32, device=src.device)
        res["library_ms"][bname] = cuda_ms(lambda: table.index_add_(0, idx_keep, src), reps=3 * more)
        lib = torch.zeros_like(table).index_add_(0, idx_keep, src)
        err_k, err_l, tol, top = bucket_errors(d_k, lib, idx_keep, src, s)
        errs[bname] = err_k.max().item()
        print(f"{tag} {bname} over all {n_rows} rows ({k} columns) against float64 index_add_: "
              f"max|d| {err_k.max().item():.3e}, max |d| / tol {(err_k / tol).max().item():.3f} "
              f"(float32 index_add_ {err_l.max().item():.3e}, {(err_l / tol).max().item():.3f}); "
              f"table max {top:.3e}")
        if not bool((err_k <= tol).all()):
            raise RuntimeError(f"full width: {bname} kernel disagrees with index_add_")
        res["bucket_rows"][bname] = n_rows
        del idx_keep, src, table, lib, err_k, err_l, tol
    del resi, ct_planes
    res["full_width_errs"] = errs
    res["plain_ms"] = plain_ms
    res["ms"] = ms
    res["bound_ms"] = {k: max(v) * 1e3 for k, v in bound.items()}
    res["bound_by"] = {k: "operations" if v[0] >= v[1] else "bytes" for k, v in bound.items()}
    for k in ms:
        print(f"kernel {k} at {cfg.width}x{cfg.height}x{call.n_samples}spp (n_iter {b}): "
              f"{ms[k]:.3f} ms, bound {res['bound_ms'][k]:.3f} ms ({res['bound_by'][k]}), "
              f"{res['bound_ms'][k] / ms[k]:.3f} of bound")
    for k, t in res["library_ms"].items():
        print(f"index_add_ on the {k} rows ({res['bucket_rows'][k]}): {t:.3f} ms")
    print(f"chunk iterations {iters:.0f}")
    return res


def phase4e_emissive(tpt, dev, lib):
    """Phase 4e: the persistent kernel's emissive build (``kEmit``) on the
    ``smallpt`` preset's full 1024x768 frame at SMALLPT_SPP spp: ``render()``
    must launch it once and no plain version, 2,048 random pixels of the
    kernel's sums and counts must equal the plain version's bit for bit, and
    the kernel is timed beside its FP32 scan bound and an estimate of its
    INT32 RNG bound (every segment taken as a hit: 2 threefry evaluations a
    path, 3 a segment, one a roulette draw at most a segment; the
    benchmark's ``persistent_lit_roofline`` counts them exactly).  At the
    cell's 256 spp (several sample groups) 512 of those pixels must equal
    the plain version bit for bit, and the kernel and its combine are timed
    by the profiler.  Returns the kernels JSON's row."""
    from simplepathtracer_tpu_torch.ops import persistent
    from simplepathtracer_tpu_torch.render import _persistent_args

    scene, cam, cfg = tpt.PRESETS["smallpt"].build(0, device=dev)
    cfg = cfg.replace(spp=SMALLPT_SPP)
    key = tpt.make_key(7)
    tpt.render(scene, cam, cfg.replace(width=64, height=48, spp=2), key)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = tpt.render(scene, cam, cfg, key)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    since = counts_since_reset()
    emit, plain_calls = since["launch.persistent.emit"], since["plain.render_block_persistent_reference"]
    paths = cfg.num_pixels * cfg.spp
    print(f"phase4e smallpt {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth} "
          f"rr={cfg.rr_start_depth} t_min={cfg.t_min}: render() {render_s:.4f} s, "
          f"{paths / render_s / 1e6:.2f} Mpaths/s, emissive launches={emit}, plain calls={plain_calls}")
    if emit != 1 or since["launch.persistent"] != 1 or plain_calls != 0:
        raise RuntimeError("phase4e: render() did not run through the emissive build alone")
    if not torch.isfinite(img).all() or img.max() <= 0:
        raise RuntimeError("phase4e: the lit image is not finite or is all zero")

    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    call = (tables, sky6, cam19, key, 0, cfg.spp, cfg.max_depth, cfg.width, cfg.height)
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth,
              emission=scene.emission)
    sums, counts = persistent.render_block_persistent(pix, *call, **kw, return_counts=True)
    gen = torch.Generator().manual_seed(1)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_counts = persistent.render_block_persistent_reference(rows, *call, **kw,
                                                                   return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    d = (sums[rows] - ref).abs().max().item()
    bad_counts = (counts[rows] != ref_counts).sum().item()
    print(f"phase4e {N_CHECK_PIXELS} random pixels: max|d| of sums={d:.3e}, rows with unequal "
          f"counts={bad_counts}, plain {plain_ms:.1f} ms")
    if not (d == 0.0 and bad_counts == 0):
        raise RuntimeError("phase4e: the emissive build disagrees with its plain version")

    ms = cuda_ms(lambda: persistent.render_block_persistent(pix, *call, **kw), reps=3)
    iters = counts.double().sum().item()
    live = int(torch.isfinite(scene.radii).sum().item())
    scan_ms = iters * live * FLOPS_PER_SPHERE_TEST / PEAK_FP32 * 1e3
    rng_ms = (2 * paths + 4 * iters) * THREEFRY_INT_OPS / PEAK_INT32 * 1e3
    bound_ms = max(scan_ms, rng_ms)
    usage = ptxas_usage(lib.log, "persistent_kernelILb1EE")
    # The cell's 256 spp: several sample groups, their sums added by the
    # combine; the full frame against the plain version on some pixels.
    n_cell = 256
    call256 = call[:5] + (n_cell,) + call[6:]
    sums256 = persistent.render_block_persistent(pix, *call256, **kw)
    rows256 = rows[:N_CHECK_PIXELS // 4]
    ref256 = persistent.render_block_persistent_reference(rows256, *call256, **kw)
    d256 = (sums256[rows256] - ref256).abs().max().item()
    split = persistent_split_ms(lambda: persistent.render_block_persistent(pix, *call256, **kw))
    print(f"phase4e {len(rows256)} random pixels at {n_cell} spp "
          f"({persistent.sample_groups(n_cell)} sample groups): max|d| of sums={d256:.3e}; "
          f"profiled persistent_kernel<true> / persistent_kernel_combine ms: {split}")
    if d256 != 0.0:
        raise RuntimeError("phase4e: the emissive build's group sums disagree with its plain version")
    d = max(d, d256)
    print(f"kernel smallpt (emissive build): {ms:.3f} ms, iterations {iters:.0f} "
          f"({iters / paths:.3f} per path), {iters / ms / 1e6:.2f} G segments/s, bound "
          f"{bound_ms:.3f} ms (scan {scan_ms:.3f}, RNG at most {rng_ms:.3f}), "
          f"{bound_ms / ms:.3f} of bound; {usage.get('registers')} registers, "
          f"{usage.get('spill_bytes')} B spilled, {usage.get('stack_bytes')} B stack frame")
    return {
        "name": "persistent_render_emit", "route": "cuda",
        "source": "simplepathtracer_tpu_torch/csrc/persistent.cu",
        "replaces": None, "launches": emit, "max_abs_err": d, "ms": ms,
        "plain_ms": plain_ms, "plain_ms_shape": f"{N_CHECK_PIXELS} pixels x {cfg.spp} spp",
        "bound_ms": bound_ms, "bound_by": "operations (INT32)" if rng_ms >= scan_ms else
        "operations (FP32)", "ms_shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp",
        "iterations_per_path": iters / paths, "render_s": render_s, **usage,
        "split_ms_256spp": split,
    }


def poke_scene(tpt, dev):
    """Three Lambertian spheres poking through the ground plane
    (tests/test_crossing.py:_poke_scene): the first one half buried."""
    from simplepathtracer_tpu_torch import scenes

    sc = scenes._scene_from_arrays(
        [[0.0, -0.5, 1.0], [0.9, -0.35, 1.3], [-0.85, -0.62, 0.9]], [0.4, 0.3, 0.35],
        [[0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [0.7, 0.15, 0.15]], [0, 0, 0], [0.0, 0.0, 0.0],
        [1.5, 1.5, 1.5], scenes.SHIRLEY_SKY_LO, scenes.SHIRLEY_SKY_HI, dev,
    )
    return tpt.with_ground_plane(sc)


def decoupled_chunks(cfg, gcfg):
    """(chunk, chunks) of the samples the decoupled loss differentiates:
    the second half, in the largest chunk that divides it and fits
    ``gcfg.spp_chunk`` (render_pixel_block)."""
    half = cfg.spp // 2
    chunk = min(gcfg.spp_chunk or half, half)
    chunk = next(c for c in range(chunk, 0, -1) if half % c == 0)
    return chunk, half // chunk


def phase7_soft(tpt, dev, wrappers):
    """Soft silhouettes on the main path: ``fit`` with its own defaults
    (softness 0.02, every leaf) at full width, through the soft kernels
    only; each soft kernel at that fit's chunk against its plain version on
    random lanes; the plane leaf of ``three_sphere_plane`` at full size
    (the crossing coin live), with the soft plane instantiations held
    against their plain versions at that fit's chunk; and an AD/FD check
    through the kernels.  Returns what the report needs."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    out = {}
    lap()
    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    # (a) The default fit.  The target is rendered soft-to-soft through the
    # gradient route (the persistent kernel ignores softness); the start
    # dims albedo and sky and moves three object centers along x.  The
    # param_mask lets those three centers move along x only (so their error
    # is the offset's), and every radius but the r=1000 ground sphere's.
    soft_cfg = tpt.grad_safe_config(cfg.replace(silhouette_softness=DEFAULT_SOFTNESS), dev)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, soft_cfg, tpt.fold_in(key, 1000))
    centers = scene.centers.clone()
    centers[1:4, 0] += CENTER_START
    start = scene.replace(albedo=scene.albedo * ALBEDO_START, sky_lo=scene.sky_lo * SKY_START,
                          sky_hi=scene.sky_hi * SKY_START, centers=centers)
    mask = {"centers": torch.zeros_like(scene.centers), "radii": torch.ones_like(scene.radii)}
    mask["centers"][1:4, 0] = 1.0
    mask["radii"][0] = 0.0
    fit_kw = dict(lr=FIT_LR, param_mask=mask, device=dev)
    tpt.fit(start, target, cam, cfg, key, steps=1, **fit_kw)
    sync(dev)
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit(start, target, cam, cfg, key, steps=FIT_STEPS, **fit_kw)
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / FIT_STEPS
    out["fit_peak_gb"] = peak_gb(dev)
    out["launches"] = launch_counts()
    out["plain_calls"] = plain_calls(wrappers)
    out["losses"] = losses
    err_x = (fitted.centers[1:4, 0] - scene.centers[1:4, 0]).abs().mean().item()
    err_x0 = (start.centers[1:4, 0] - scene.centers[1:4, 0]).abs().mean().item()
    err_r = (fitted.radii[1:] - scene.radii[1:]).abs().mean().item()
    err_alb = (fitted.albedo - scene.albedo).abs().mean().item()
    err_alb0 = (start.albedo - scene.albedo).abs().mean().item()
    g_chunk, n = decoupled_chunks(cfg, soft_cfg)
    out.update(chunk=g_chunk, n_chunks=n, center_x_err=(err_x0, err_x), radius_err=err_r)
    print(f"phase7 fit, default arguments (softness {DEFAULT_SOFTNESS}, every leaf, decoupled "
          f"loss: {cfg.spp // 2} spp differentiated in {n} chunks of {g_chunk}), {FIT_STEPS} "
          f"steps: losses {losses}, {out['step_s']:.3f} s/step, peak {out['fit_peak_gb']:.2f} GB, "
          f"mean|x of centers 1-3 - truth| {err_x0:.4f} -> {err_x:.4f}, mean|radius - truth| "
          f"(started at truth) {err_r:.4f}, mean|albedo - truth| {err_alb0:.4f} -> "
          f"{err_alb:.4f}, launches {out['launches']}, plain calls {out['plain_calls']}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0] and err_x < err_x0):
        raise RuntimeError("phase7: the default fit's loss or centre error did not fall")
    # Per step: a forward of each half's chunks; per differentiated chunk a
    # backward and both buckets, and on the streamed route (several chunks)
    # a re-forward.
    want = {"regen_fwd_soft": 2 * n, "regen_bwd_soft": n, "bucket": n, "bucket_blocker": n}
    if n > 1:
        want["regen_refwd_soft"] = n
    if out["launches"] != {k: v * FIT_STEPS for k, v in want.items()} or any(
            out["plain_calls"].values()):
        raise RuntimeError(f"phase7: the default fit did not run through the soft kernels only "
                           f"(launches {out['launches']}, per step wanted {want}, plain calls "
                           f"{out['plain_calls']})")
    out["per_step"] = want
    # The same fit with SIL_FRESNEL on, between two runs with it off: the
    # first loss is the same (no forward value changes), the step time
    # beside the switch-off one.
    out["fresnel_fit"] = {}
    for label, on in (("on", True), ("off", False)):
        with sil_fresnel(on):
            sync(dev)
            t0 = time.perf_counter()
            _, l_f = tpt.fit(start, target, cam, cfg, key, steps=FRESNEL_STEPS, **fit_kw)
            sync(dev)
        out["fresnel_fit"][label] = dict(s_per_step=(time.perf_counter() - t0) / FRESNEL_STEPS,
                                         losses=l_f)
    print(f"phase7 fit with SIL_FRESNEL on / off, {FRESNEL_STEPS} steps: "
          f"{json.dumps(out['fresnel_fit'])} (off before: {out['step_s']:.4f} s/step)")
    if out["fresnel_fit"]["on"]["losses"][0] != losses[0]:
        raise RuntimeError("phase7: SIL_FRESNEL changed the fit's first loss")
    lap("phase7 (a) default fit")

    # (b) Each soft kernel at that fit's chunk shape.
    gen = torch.Generator().manual_seed(4)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    call = gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key, pix,
                         n_samples=g_chunk, max_depth=cfg.max_depth, width=cfg.width,
                         height=cfg.height, t_min=cfg.t_min, t_max=cfg.t_max,
                         rr_start_depth=cfg.rr_start_depth, softness=DEFAULT_SOFTNESS)
    out.update(full_width_kernels(gr, bucket, call, scene, cfg, rows))
    lap("phase7 (b) soft kernels at full width")

    # (c) three_sphere_plane at its full size: the plane leaf alone, default
    # softness (soft-to-soft target, offset and albedo moved).  The fit runs
    # twice: with the preset's chunking (one chunk: the full-residual
    # forward) and in 4 chunks (the streamed route: idx-only forward and
    # re-forward), so every soft plane instantiation runs at full size.
    scene_p, cam_p, cfg_p = tpt.PRESETS["three_sphere_plane"].build(0, device=dev)
    gcfg_p = tpt.grad_safe_config(cfg_p.replace(silhouette_softness=DEFAULT_SOFTNESS), dev)
    with torch.no_grad():
        target_p = tpt.render_linear(scene_p, cam_p, gcfg_p, tpt.fold_in(key, 1000))
    plane = scene_p.plane.clone()
    plane[3] += 0.05
    plane[4:7] *= 0.8
    start_p = scene_p.replace(plane=plane)
    chunk_p, n_p = decoupled_chunks(cfg_p, gcfg_p)
    stream_chunk = chunk_p // 4
    reset_counts()
    fits = []
    for spp_chunk in (cfg_p.spp_chunk, stream_chunk):
        t0 = time.perf_counter()
        fitted_p, losses_p = tpt.fit(start_p, target_p, cam_p, cfg_p.replace(spp_chunk=spp_chunk),
                                     key, steps=FIT_STEPS, lr=FIT_LR, leaves=("plane",),
                                     device=dev)
        sync(dev)
        fits.append(dict(spp_chunk=spp_chunk, losses=losses_p,
                         s_per_step=(time.perf_counter() - t0) / FIT_STEPS,
                         offset=fitted_p.plane[3].item()))
    launches_p = launch_counts()
    plain_p = plain_calls(wrappers)
    for f in fits:
        print(f"phase7 three_sphere_plane {cfg_p.width}x{cfg_p.height}x{cfg_p.spp}spp depth "
              f"{cfg_p.max_depth}, plane leaf, default softness, spp_chunk {f['spp_chunk']}: "
              f"losses {f['losses']}, {f['s_per_step']:.3f} s/step, offset "
              f"{start_p.plane[3].item():.4f} -> {f['offset']:.4f} (truth "
              f"{scene_p.plane[3].item():.4f})")
    print(f"phase7 three_sphere_plane fits ({n_p} + 4 chunks per step): launches {launches_p}, "
          f"plain calls {plain_p}")
    steps_chunks = FIT_STEPS * (n_p + 4)
    if not (all(all(map(math.isfinite, f["losses"])) and f["losses"][-1] < f["losses"][0]
                for f in fits)
            and set(launches_p) == {"regen_fwd_soft_plane", "regen_refwd_soft_plane",
                                    "regen_bwd_soft_plane", "bucket", "bucket_blocker"}
            and launches_p["regen_refwd_soft_plane"] == FIT_STEPS * 4
            and launches_p["regen_bwd_soft_plane"] == steps_chunks
            and launches_p["bucket"] == launches_p["bucket_blocker"] == steps_chunks
            and not any(plain_p.values())):
        raise RuntimeError("phase7: the three_sphere_plane plane fit failed")
    lap("phase7 (c) plane fits")

    # The soft plane instantiations at the streamed fit's chunk (the plain
    # versions' time grows with the chunk's samples), and the crossing
    # coin's share of that chunk's plane hits.
    inputs_p, cam19_p = gr._trace_inputs(start_p, cam_p, cfg_p)
    call_p = gr.regen_call(inputs_p[:11], inputs_p[11], inputs_p[12], cam19_p, key,
                           torch.arange(cfg_p.num_pixels, device=dev), n_samples=stream_chunk,
                           max_depth=cfg_p.max_depth, width=cfg_p.width, height=cfg_p.height,
                           t_min=cfg_p.t_min, t_max=cfg_p.t_max,
                           rr_start_depth=cfg_p.rr_start_depth, softness=DEFAULT_SOFTNESS)
    rows_p = torch.randperm(cfg_p.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    plane_k = full_width_kernels(gr, bucket, call_p, start_p, cfg_p, rows_p)
    codes = plane_k["codes"]
    print(f"phase7 three_sphere_plane chunk of {stream_chunk} spp: plane hits decided by the crossing "
          f"coin against an in-band sphere {codes['crossing_loser']} of {codes['plane']}")
    if codes["crossing_loser"] == 0:
        raise RuntimeError("phase7: no crossing-loser plane win at full size")
    out["plane_fit"] = dict(fits=fits, chunk=stream_chunk, codes=codes,
                            shape=f"{cfg_p.width}x{cfg_p.height}x{stream_chunk}spp")
    out["plane_launches"] = launches_p
    out["plane_kernels"] = plane_k
    lap("phase7 (c) soft plane kernels at full size")

    # (d) AD/FD of the half-buried sphere's radius through the kernels
    # (tests/test_crossing.py:132-169: 48x24, 512 spp, depth 3).
    scene_b = poke_scene(tpt, dev)
    cam_b = tpt.make_camera(origin=(0.0, 0.5, -1.2), lookat=(0.0, -0.35, 1.0), vfov_deg=55,
                            device=dev)
    cfg_b = tpt.RenderConfig(width=48, height=24, spp=512, max_depth=3, use_pallas=True,
                             silhouette_softness=ADFD_SOFTNESS)
    prng = np.random.default_rng(11)
    pert = scene_b.replace(
        centers=scene_b.centers + torch.tensor(0.04 * prng.standard_normal((3, 3)),
                                               dtype=torch.float32, device=dev),
        radii=scene_b.radii * torch.tensor(1.0 + 0.05 * prng.standard_normal(3),
                                           dtype=torch.float32, device=dev),
    )
    g_cfg = tpt.grad_safe_config(cfg_b, dev)
    with torch.no_grad():
        target_b = tpt.render_linear(pert, cam_b, g_cfg, tpt.make_key(99))
    params, _ = tpt.split_params(scene_b)
    reset_counts()

    def loss_b(radii):
        p = dict(params, radii=radii)
        return tpt.pixel_loss(p, scene_b, target_b, cam_b, cfg_b, tpt.make_key(7), device=dev)

    r = params["radii"].detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_b(r), [r])
    ad = g[0].item()
    v = torch.zeros_like(r)
    v[0] = 1.0
    with torch.no_grad():
        fd = (loss_b(r + ADFD_EPS * v).item() - loss_b(r - ADFD_EPS * v).item()) / (2 * ADFD_EPS)
    ratio = ad / fd if fd else float("nan")
    launches_b = launch_counts()
    plain_b = plain_calls(wrappers)
    print(f"phase7 AD/FD, half-buried sphere's radius (48x24, 512 spp, depth 3, soft "
          f"{ADFD_SOFTNESS}, eps {ADFD_EPS}): AD {ad:.6e}, FD {fd:.6e}, AD/FD {ratio:.4f} "
          f"(bound {ADFD_BOUNDS}); launches {launches_b}, plain calls {plain_b}")
    if not (ADFD_BOUNDS[0] < ratio < ADFD_BOUNDS[1]
            and launches_b.get("regen_bwd_soft_plane", 0) > 0
            and set(launches_b) <= {"regen_fwd_soft_plane", "regen_refwd_soft_plane",
                                    "regen_bwd_soft_plane", "bucket", "bucket_blocker"}
            and not any(plain_b.values())):
        raise RuntimeError("phase7: AD/FD through the kernels out of its bound")
    out["adfd"] = dict(ad=ad, fd=fd, ratio=ratio)
    return out


def phase7e_lit(tpt, dev, wrappers):
    """Phase 7e: gradients of an emitter-lit scene on the main path, at the
    shape of the benchmark cell ``smallpt_fit.fit_lit``: ``fit`` of the
    ``smallpt`` preset's 1024x768 frame at LIT_SPP spp with its defaults
    (softness 0.02, every leaf and the emission, the decoupled loss) from a
    soft-to-soft target, the start's albedo x 0.6, emission x 0.7 and the
    two balls +1 in x (free: their centers in x and z and their radii, the
    light's emission, every albedo, fuzz, ior and the sky).  Its launches
    are counted from zero over the timed steps and must be the emissive
    builds' alone (per step 2n idx-only forwards, n re-forwards, n
    backwards, n 12-column and n blocker buckets, no plain call); its
    losses must be finite and the light's emission must rise.  Then each
    emissive kernel at that fit's chunk on 2,048 random lanes against its
    plain version (``full_width_kernels``).  Returns what the report
    needs."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    out = {}
    lap()
    scene, cam, cfg = tpt.PRESETS["smallpt"].build(0, device=dev)
    cfg = cfg.replace(spp=LIT_SPP)
    key = tpt.make_key(0)
    soft_cfg = tpt.grad_safe_config(cfg.replace(silhouette_softness=DEFAULT_SOFTNESS), dev)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, soft_cfg.replace(spp=LIT_TARGET_SPP),
                                   tpt.fold_in(key, 1000))
    centers = scene.centers.clone()
    centers[LIT_BALLS, 0] += 1.0
    start = scene.replace(albedo=scene.albedo * ALBEDO_START, centers=centers,
                          emission=scene.emission * LIT_EMISSION_START)
    mask = {"centers": torch.zeros_like(scene.centers), "radii": torch.zeros_like(scene.radii),
            "emission": torch.zeros_like(scene.emission)}
    for axis in (0, 2):
        mask["centers"][LIT_BALLS, axis] = 1.0
    mask["radii"][LIT_BALLS] = 1.0
    mask["emission"][LIT_LIGHT] = 1.0
    fit_kw = dict(lr=FIT_LR, param_mask=mask, device=dev)
    tpt.fit(start, target, cam, cfg, key, steps=1, **fit_kw)
    sync(dev)
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit(start, target, cam, cfg, key, steps=FIT_STEPS, **fit_kw)
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / FIT_STEPS
    out["fit_peak_gb"] = peak_gb(dev)
    out["launches"] = launch_counts()
    out["plain_calls"] = plain_calls(wrappers)
    out["losses"] = losses
    e0 = start.emission[LIT_LIGHT, 0].item()
    e1 = fitted.emission[LIT_LIGHT, 0].item()
    g_chunk, n = decoupled_chunks(cfg, soft_cfg)
    out.update(chunk=g_chunk, n_chunks=n, emission=(e0, e1))
    print(f"phase7e smallpt fit {cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth} "
          f"(softness {DEFAULT_SOFTNESS}, every leaf and the emission, decoupled loss: "
          f"{cfg.spp // 2} spp differentiated in {n} chunks of {g_chunk}), {FIT_STEPS} steps: "
          f"losses {losses}, {out['step_s']:.4f} s/step, peak {out['fit_peak_gb']:.2f} GB, "
          f"light's emission {e0:.4f} -> {e1:.4f} (truth "
          f"{scene.emission[LIT_LIGHT, 0].item():.1f}), launches {out['launches']}, plain calls "
          f"{out['plain_calls']}")
    if not (all(map(math.isfinite, losses)) and e1 > e0):
        raise RuntimeError("phase7e: the lit fit's losses are not finite or its light's "
                           "emission did not rise")
    want = {"regen_fwd_soft_emit": 2 * n, "regen_bwd_soft_emit": n, "bucket_emit": n,
            "bucket_blocker": n}
    if n > 1:
        want["regen_refwd_soft_emit"] = n
    if out["launches"] != {k: v * FIT_STEPS for k, v in want.items()} or any(
            out["plain_calls"].values()):
        raise RuntimeError(f"phase7e: the lit fit did not run through the emissive builds only "
                           f"(launches {out['launches']}, per step wanted {want}, plain calls "
                           f"{out['plain_calls']})")
    out["per_step"] = want
    lap("phase7e (a) lit fit")

    # (b) Each emissive kernel at that fit's chunk shape.
    gen = torch.Generator().manual_seed(5)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    inputs, cam19 = gr._trace_inputs(start, cam, cfg)
    call = gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key,
                         torch.arange(cfg.num_pixels, device=dev), n_samples=g_chunk,
                         max_depth=cfg.max_depth, width=cfg.width, height=cfg.height,
                         t_min=cfg.t_min, t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth,
                         softness=DEFAULT_SOFTNESS, emission=inputs[13])
    out.update(full_width_kernels(gr, bucket, call, start, cfg, rows))
    lap("phase7e (b) emissive kernels at full width")
    return out


def fused_keys(w, h, spp, key, dev):
    """The ray context of every pixel of a w x h frame for samples 0 ..
    spp - 1, sample-major (render_pixel_block's order)."""
    from simplepathtracer_tpu_torch.ops.sampling import ray_keys

    p = w * h
    pids = torch.arange(p, device=dev).repeat(spp)
    sids = torch.arange(spp, device=dev).repeat_interleave(p)
    return ray_keys(key, pids, sids)


def fused_call_for(fg, scene, keys, cfg):
    from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs

    inputs = scene_inputs(scene)
    return fg.fused_call(inputs[:11], inputs[11], keys.k0, keys.k1, max_depth=cfg.max_depth,
                         t_min=cfg.t_min, t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth,
                         softness=cfg.silhouette_softness)


def sub_keys(keys, rows):
    return keys._replace(pixel=keys.pixel[rows], sample=keys.sample[rows])


def live_spheres(scene):
    return ((scene.radii.abs() > 1e-3) & (scene.centers[:, 1] > -1e6)).sum().item()


def sum_errors(got, terms):
    """|d| of a kernel's sums ``got`` [K] against the float64 sum of their
    terms [K, R] (added in another order, with atomics), and the bound of
    each (BUCKET_* above)."""
    ref = terms.double().sum(dim=-1)
    tol = (BUCKET_RTOL * ref.abs() + BUCKET_ATOL_REL * terms.abs().max().double()
           + BUCKET_SUM_ROUNDINGS * F32_EPS * terms.double().abs().sum(dim=-1))
    return (got.double() - ref).abs(), tol


def fused_fwd_bytes(soft, n, n_live, n_miss):
    """Bytes one fused forward launch over ``n`` rays must move, ``n_live``
    of them alive at entry and ``n_miss`` of those missing: a live ray
    reads its entry state 40, pixel and sample ids 8 (soft: previous winner
    4) and writes its next state 40 and winner index 4 (soft: blocker and
    previous winner 8); a miss adds its radiance, 12 read and 12 written.
    A dead ray needs only its alive flag read and written and its index
    (soft: and blocker and previous winner) written: copying its state is
    the kernel's design, not the function's need."""
    live = 40 + 8 + 40 + 4 + (12 if soft else 0)
    dead = 4 + 4 + 4 + (8 if soft else 0)
    return n_live * live + n_miss * 24 + (n - n_live) * dead


def fused_bwd_bytes(soft, want_attr, n, n_live):
    """Bytes one fused backward launch over ``n`` rays must move, ``n_live``
    of them alive at that bounce: a live ray reads its entry state 40,
    indices 4 (soft 8), pixel and sample ids 8, carried cotangents 36 and
    radiance cotangent 12 and writes carried cotangents 36; a dead ray reads
    its alive flag 4 and passes its carried cotangents through, 36 in and
    36 out.  Each writes its attribute cotangents, 36 (soft 52), when they
    are asked for."""
    attr = (52 if soft else 36) if want_attr else 0
    live = 40 + (8 if soft else 4) + 8 + 36 + 12 + 36 + attr
    dead = 4 + 36 + 36 + attr
    return n_live * live + (n - n_live) * dead


def sky_terms(fg, call, state, idx, bidx, pix, samp, bounce, carry, ct_rad):
    """The sky's 6 cotangents of one backward bounce per ray, [6, N]: the
    terms the kernel sums (ops/bounce.py:bounce_tile_adjoint on the plain
    version's inputs), for a bound on that sum in another order."""
    from simplepathtracer_tpu_torch.ops.bounce import bounce_tile_adjoint

    o, d, tp, alive, u = fg._bounce_inputs(call, state, pix, samp, bounce)
    i64 = idx.to(torch.int64)
    a9, mat = fg._winner(call, i64)
    g = bounce_tile_adjoint(
        o, d, tp, a9, mat, i64 >= 0, alive, u, tuple(call.consts[i] for i in range(6)),
        bounce >= call.rr_start_depth, tuple(carry[0:3]), tuple(carry[3:6]),
        tuple(carry[6:9]), tuple(ct_rad), t_min=call.t_min, t_max=call.t_max,
        rr_on=bool(call.rr_start_depth), **fg._bounce_kwargs(call, bidx))
    return torch.stack(g.sky)


def phase8_kernels(tpt, dev):
    """The fused kernels against their plain versions at small shapes: raygen,
    each forward bounce and each backward bounce bit for bit, the sky sums
    and the buckets inside the float64 bound, and pixel_loss through the
    fused route against its plain route.  Returns ({kernel: max |d|},
    {kernel: plain ms per launch}, {kernel: kernel ms per launch},
    {kernel: shape of those times})."""
    from simplepathtracer_tpu_torch.ops import bucket, grad as fg
    from simplepathtracer_tpu_torch.ops.persistent import camera_constants

    def cover():
        return tpt.compact_scene(tpt.cover_scene(0, device=dev)), tpt.PRESETS["cover"].camera_fn(dev)

    def trio():
        return (tpt.three_sphere_scene(device=dev),
                tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device=dev))

    cases = [
        # name, scene and camera, w, h, spp, depth, rr, softness
        ("cover", cover, 64, 32, 4, 10, 0, 0.0),
        ("cover_soft", cover, 64, 32, 4, 10, 0, 0.05),
        ("three_sphere", trio, 48, 24, 8, 10, 2, 0.0),
        ("three_sphere_soft", trio, 48, 24, 8, 10, 2, 0.05),
        # The soft instantiations with SIL_FRESNEL on.
        ("cover_soft_fresnel", cover, 64, 32, 4, 10, 0, 0.05),
        ("three_sphere_soft_fresnel", trio, 48, 24, 8, 10, 2, 0.05),
    ]
    errs = {name: 0.0 for name, _, _ in FUSED_KERNELS}
    plain_ms, kernel_ms, shapes = {}, {}, {}
    gen = torch.Generator().manual_seed(6)
    key = tpt.make_key(8)
    for name, build, w, h, spp, depth, rr, softness in cases:
        with sil_fresnel(name.endswith("_fresnel")):
            scene, cam = build()
            soft = softness > 0.0
            sfx = "_soft" if soft else ""
            cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr,
                                   silhouette_softness=softness)
            tag = (f"phase8 {name} {w}x{h}x{spp}spp depth {depth} rr {rr} soft {softness} "
                   f"fresnel={name.endswith('_fresnel')}")
            keys = fused_keys(w, h, spp, key, dev)
            n = keys.pixel.shape[0]
            pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()

            rays = fg.raygen(cam, keys, cfg)
            sync(dev)
            rays_p = fg.raygen_reference(cam, keys, cfg)
            rays_ok = torch.equal(rays, rays_p)
            errs["raygen"] = max(errs["raygen"], (rays - rays_p).abs().max().item())
            call = fused_call_for(fg, scene, keys, cfg)

            # Forward, bounce by bounce: kernel and plain version on the same
            # entry state, every output bit for bit.
            state = torch.cat([rays, torch.ones((4, n), device=dev)]).contiguous()
            rad = torch.zeros((3, n), device=dev)
            prev = torch.full((n,), -1, dtype=torch.int32, device=dev) if soft else None
            saved, fwd_ok = [], True
            for b in range(depth):
                rad_p = rad.clone()
                got = fg.grad_forward(call, state, rad, prev, pix, samp, b)
                want = fg.grad_fwd_reference(call, state, rad_p, prev, pix, samp, b)
                sync(dev)
                fwd_ok = fwd_ok and torch.equal(rad, rad_p) and all(
                    (g is None and x is None) or torch.equal(g, x) for g, x in zip(got, want))
                errs["grad_fwd" + sfx] = max(errs["grad_fwd" + sfx], (rad - rad_p).abs().max().item(),
                                             (got[0] - want[0]).abs().max().item())
                saved.append((state, got[2], got[3]))
                state, prev = got[0], got[1]

            # Backward, bounce by bounce: carried and attribute cotangents bit for
            # bit; the sky sums and the buckets against float64 sums.
            ct_rad = (torch.randn((3, n), generator=gen) * 1e-3).to(dev)
            carry = torch.zeros((9, n), device=dev)
            bwd_ok, sky_ratio, bucket_ratio = True, 0.0, 0.0
            s = call.n_spheres
            for b in range(depth - 1, -1, -1):
                st, idx, bidx = saved[b]
                ck, ak, sk = fg.grad_backward(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
                sync(dev)
                cp, ap, _ = fg.grad_bwd_reference(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
                bwd_ok = bwd_ok and torch.equal(ck, cp) and torch.equal(ak, ap)
                err, tol = sum_errors(sk, sky_terms(fg, call, st, idx, bidx, pix, samp, b, carry,
                                                    ct_rad))
                sky_ratio = max(sky_ratio, (err / tol).max().item())
                errs["grad_bwd" + sfx] = max(errs["grad_bwd" + sfx], (ck - cp).abs().max().item(),
                                             (ak - ap).abs().max().item(), err.max().item())
                cols = [(ak[:9], idx)] + ([(ak[9:], bidx)] if soft else [])
                for c, ix in cols:
                    d_k = bucket.bucket_cols(c, ix, s)
                    d_p = bucket.bucket_cols_reference(c, ix, s)
                    e_k, _, tol_b, _ = bucket_errors(d_k, d_p, *bucket_rows(c, ix, s), s)
                    bucket_ratio = max(bucket_ratio, (e_k / tol_b).max().item())
                carry = ck
            print(f"{tag}: raygen {'bit-exact' if rays_ok else 'DIFFERS'}, forward {depth} bounces "
                  f"{'bit-exact' if fwd_ok else 'DIFFER'} (alive after the last "
                  f"{int(saved[-1][0][9].sum().item())} of {n}), backward cotangents "
                  f"{'bit-exact' if bwd_ok else 'DIFFER'}, sky sums max |d| / tol {sky_ratio:.3f}, "
                  f"buckets max |d| / tol {bucket_ratio:.3f}")
            if not (rays_ok and fwd_ok and bwd_ok and sky_ratio <= 1.0 and bucket_ratio <= 1.0
                    and torch.isfinite(carry).all()):
                raise RuntimeError(f"{tag}: a fused kernel disagrees with its plain version")

            # pixel_loss through the fused route against its plain route.
            gcfg = cfg.replace(use_pallas_grad=True)
            target = torch.full((h, w, 3), 0.25, device=dev)
            l_k, g_k = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
            with plain_route(FUSED_ROUTE):
                l_p, g_p = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
            ok, worst = grads_close(list(g_k.values()), list(g_p.values()))
            print(f"{tag}: pixel_loss fused kernels {l_k.item():.9g} plain {l_p.item():.9g}, "
                  f"gradients max|d| {worst:.3e} over {len(g_k)} leaves")
            if not (ok and torch.equal(l_k, l_p)):
                raise RuntimeError(f"{tag}: pixel_loss through the fused kernels disagrees with "
                                   "the plain route")

            if name in ("cover", "cover_soft") and dev.type == "cuda":
                # Per-launch times of the whole chain at this shape.
                shape = f"{name} {w}x{h}x{spp}spp depth {depth}"

                def chain(fwd):
                    st, rd = torch.cat([rays, torch.ones((4, n), device=dev)]), torch.zeros((3, n), device=dev)
                    pv = torch.full((n,), -1, dtype=torch.int32, device=dev) if soft else None
                    for b in range(depth):
                        st, pv, _, _ = fwd(call, st, rd, pv, pix, samp, b)

                def back(bwd):
                    c = torch.zeros((9, n), device=dev)
                    for b in range(depth - 1, -1, -1):
                        st, idx, bidx = saved[b]
                        c = bwd(call, st, idx, bidx, pix, samp, b, c, ct_rad)[0]

                timed = [("grad_fwd" + sfx, lambda: chain(fg.grad_forward),
                          lambda: chain(fg.grad_fwd_reference), depth),
                         ("grad_bwd" + sfx, lambda: back(fg.grad_backward),
                          lambda: back(fg.grad_bwd_reference), depth)]
                if not soft:
                    cam19 = camera_constants(cam, w, h).detach().contiguous()
                    timed.append(("raygen", lambda: fg._raygen_launch(cam19, keys, w, h),
                                  lambda: fg.raygen_reference(cam, keys, cfg), 1))
                for kname, kern, plain, per in timed:
                    plain_ms[kname] = cuda_ms(plain, reps=1, warm=False) / per
                    kernel_ms[kname] = cuda_ms(kern, reps=5) / per
                    shapes[kname] = shape
                    print(f"phase8 {shape}: {kname} per launch plain {plain_ms[kname]:.3f} ms, "
                          f"kernel {kernel_ms[kname]:.3f} ms")
    return errs, plain_ms, kernel_ms, shapes


def fused_full_width(tpt, fg, bucket, scene, cam, cfg, key, spp, rows, want_attr):
    """Each fused kernel at a main path's launch shape (every pixel of the
    frame x ``spp`` samples, depth ``cfg.max_depth``), run kernel by kernel
    as ``_FusedTrace`` runs them: raygen, the forward bounces, the backward
    bounces (and, with ``want_attr``, the attribute cotangents and their
    buckets).  Each ray's outputs depend on that ray alone, so the kernels'
    outputs on the rays ``rows`` must equal the plain versions run on those
    rays alone, bit for bit; the buckets over every row are held against a
    float64 index_add_.  Returns the CUDA-event ms per launch (mean over the
    bounces), the bounds from this run's data (live rays per bounce), and
    the errors.  Raises on a mismatch."""
    from simplepathtracer_tpu_torch.ops.persistent import camera_constants

    dev = cam.origin.device
    soft = cfg.silhouette_softness > 0.0
    sfx = "_soft" if soft else ""
    keys = fused_keys(cfg.width, cfg.height, spp, key, dev)
    n, depth = keys.pixel.shape[0], cfg.max_depth
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    sk = sub_keys(keys, rows)
    spix, ssamp = pix[rows], samp[rows]
    tag = (f"kernel at {cfg.width}x{cfg.height}x{spp}spp ({n} rays){' soft' if soft else ''}, "
           f"{rows.numel()} random rays:")
    ms = {k: 0.0 for k in ("raygen", "grad_fwd" + sfx, "grad_bwd" + sfx)}
    bound = {k: [0.0, 0.0] for k in ms}
    errs = {k: 0.0 for k in ms}

    # The kernel alone: the host's camera arithmetic (camera_constants) is
    # the step's, not the kernel's.
    cam19 = camera_constants(cam, cfg.width, cfg.height).detach().contiguous()
    ms["raygen"] = cuda_ms(lambda: fg._raygen_launch(cam19, keys, cfg.width, cfg.height), reps=3)
    rays = fg.raygen(cam, keys, cfg)
    rays_p = fg.raygen_reference(cam, sk, cfg)
    bound["raygen"] = [0.0, n * 32 / PEAK_BYTES]
    ok = torch.equal(rays[:, rows], rays_p)

    call = fused_call_for(fg, scene, keys, cfg)
    live_s = live_spheres(scene)
    flops = FLOPS_PER_SOFT_SPHERE_TEST if soft else FLOPS_PER_SPHERE_TEST
    state = torch.cat([rays, torch.ones((4, n), device=dev)]).contiguous()
    del rays
    rad = torch.zeros((3, n), device=dev)
    prev = torch.full((n,), -1, dtype=torch.int32, device=dev) if soft else None
    st_p, rad_p = state[:, rows], torch.zeros((3, rows.numel()), device=dev)
    prev_p = prev[rows] if soft else None
    saved, live, fwd_ms = [], [], []
    for b in range(depth):
        scratch = rad.clone()
        fwd_ms.append(cuda_ms(
            lambda: fg.grad_forward(call, state, scratch, prev, pix, samp, b), reps=2))
        ms["grad_fwd" + sfx] += fwd_ms[-1] / depth
        del scratch
        nxt, prev_n, idx, bidx = fg.grad_forward(call, state, rad, prev, pix, samp, b)
        n_live = (state[9] > 0).sum().item()
        n_miss = n_live - (idx >= 0).sum().item()
        live.append(n_live)
        bound["grad_fwd" + sfx][0] += n_live * live_s * flops / PEAK_FP32 / depth
        bound["grad_fwd" + sfx][1] += fused_fwd_bytes(soft, n, n_live, n_miss) / PEAK_BYTES / depth
        got = fg.grad_fwd_reference(call, st_p, rad_p, prev_p, spix, ssamp, b)
        ok = ok and torch.equal(nxt[:, rows], got[0]) and torch.equal(idx[rows], got[2]) and (
            not soft or (torch.equal(bidx[rows], got[3]) and torch.equal(prev_n[rows], got[1])))
        errs["grad_fwd" + sfx] = max(errs["grad_fwd" + sfx], (nxt[:, rows] - got[0]).abs().max().item())
        st_p, prev_p = got[0], got[1]
        saved.append((state, idx, bidx))
        state, prev = nxt, prev_n
    ok = ok and torch.equal(rad[:, rows], rad_p)
    errs["grad_fwd" + sfx] = max(errs["grad_fwd" + sfx], (rad[:, rows] - rad_p).abs().max().item())
    print(f"{tag} raygen and {depth} forward bounces {'bit-exact' if ok else 'DIFFER'} "
          f"(live rays per bounce {live})")
    # ns per live ray-bounce: bounce 0 (coherent camera rays, all alive)
    # against the later bounces' (scattered survivors).
    ns_live = [t * 1e6 / max(1, n_l) for t, n_l in zip(fwd_ms, live)]
    ns_later = sum(fwd_ms[1:]) * 1e6 / max(1, sum(live[1:]))
    print(f"kernel grad_fwd{sfx} per bounce: ms {[round(t, 3) for t in fwd_ms]}; ns per live "
          f"ray-bounce {[round(t, 3) for t in ns_live]}; bounce 0 {ns_live[0]:.3f} ns, bounces "
          f"1-{depth - 1} {ns_later:.3f} ns")
    if not ok:
        raise RuntimeError("full width: a fused forward kernel disagrees with its plain version")
    del state, prev, st_p

    gen = torch.Generator().manual_seed(9)
    ct_rad = (torch.randn((3, n), generator=gen) * 1e-6).to(dev)
    carry = torch.zeros((9, n), device=dev)
    carry_p = carry[:, rows]
    s = call.n_spheres
    bucket_ms, bucket_bound, bucket_lib_ms, bucket_ratio, bucket_rows_n = 0.0, [0.0, 0.0], 0.0, 0.0, 0
    bwd_ms = [0.0] * depth
    call_f = fresnel_call(call) if soft else None
    fresnel_ms = 0.0
    for b in range(depth - 1, -1, -1):
        st, idx, bidx = saved[b]
        bwd_ms[b] = cuda_ms(
            lambda: fg.grad_backward(call, st, idx, bidx, pix, samp, b, carry, ct_rad, want_attr),
            reps=2)
        if soft:
            # The same launch with SIL_FRESNEL on (a runtime flag).
            fresnel_ms += cuda_ms(lambda: fg.grad_backward(call_f, st, idx, bidx, pix, samp, b,
                                                           carry, ct_rad, want_attr),
                                  reps=2) / depth
        ms["grad_bwd" + sfx] += bwd_ms[b] / depth
        ck, ak, _ = fg.grad_backward(call, st, idx, bidx, pix, samp, b, carry, ct_rad, want_attr)
        bound["grad_bwd" + sfx][0] += (live[b] * (BWD_OPS_PER_ITER_SOFT if soft else BWD_OPS_PER_ITER)
                                       / PEAK_FP32 / depth)
        bound["grad_bwd" + sfx][1] += fused_bwd_bytes(soft, want_attr, n, live[b]) / PEAK_BYTES / depth
        cp, ap, _ = fg.grad_bwd_reference(call, st[:, rows], idx[rows],
                                          bidx[rows] if soft else None, spix, ssamp, b, carry_p,
                                          ct_rad[:, rows], want_attr)
        ok = ok and torch.equal(ck[:, rows], cp) and (not want_attr or torch.equal(ak[:, rows], ap))
        errs["grad_bwd" + sfx] = max(errs["grad_bwd" + sfx], (ck[:, rows] - cp).abs().max().item())
        if want_attr:
            for c, ix in [(ak[:9], idx)] + ([(ak[9:], bidx)] if soft else []):
                bucket_ms += cuda_ms(lambda: bucket.bucket_cols(c, ix, s), reps=5)
                d_k = bucket.bucket_cols(c, ix, s)
                idx_keep, src = bucket_rows(c, ix, s)
                k = c.shape[0]
                bucket_rows_n += idx_keep.numel()
                bucket_bound[1] += (ix.numel() * 4 + idx_keep.numel() * k * 4) / PEAK_BYTES
                table = torch.zeros((s, k), dtype=torch.float32, device=dev)
                bucket_lib_ms += cuda_ms(lambda: table.index_add_(0, idx_keep, src), reps=2)
                lib = torch.zeros_like(table).index_add_(0, idx_keep, src)
                e_k, _, tol, _ = bucket_errors(d_k, lib, idx_keep, src, s)
                bucket_ratio = max(bucket_ratio, (e_k / tol).max().item())
                del idx_keep, src, table, lib
        carry, carry_p = ck, cp
        saved[b] = None
    print(f"{tag} {depth} backward bounces {'bit-exact' if ok else 'DIFFER'} (carried "
          f"{'and attribute ' if want_attr else ''}cotangents)"
          + (f"; buckets over all {bucket_rows_n} rows max |d| / tol {bucket_ratio:.3f}"
             if want_attr else ""))
    if not (ok and bucket_ratio <= 1.0 and torch.isfinite(carry).all()):
        raise RuntimeError("full width: a fused backward kernel or bucket disagrees")
    bwd_ns = [t * 1e6 / max(1, n_l) for t, n_l in zip(bwd_ms, live)]
    bwd_later = sum(bwd_ms[1:]) * 1e6 / max(1, sum(live[1:]))
    print(f"kernel grad_bwd{sfx} per bounce: ms {[round(t, 3) for t in bwd_ms]}; ns per live "
          f"ray-bounce {[round(t, 3) for t in bwd_ns]}; bounce 0 {bwd_ns[0]:.3f} ns, bounces "
          f"1-{depth - 1} {bwd_later:.3f} ns")
    res = {"ms": ms, "errs": errs, "live": live, "n_rays": n, "fwd_ms_per_bounce": fwd_ms,
           "fwd_ns_per_live_ray_bounce": ns_live, "bwd_ms_per_bounce": bwd_ms,
           "bwd_ns_per_live_ray_bounce": bwd_ns,
           "bound_ms": {k: max(v) * 1e3 for k, v in bound.items()},
           "bound_by": {k: "operations" if v[0] >= v[1] else "bytes" for k, v in bound.items()}}
    if soft:
        res["fresnel_ms"] = {"grad_bwd" + sfx: {"off": ms["grad_bwd" + sfx], "on": fresnel_ms}}
        print(f"kernel grad_bwd{sfx} per launch with SIL_FRESNEL off {ms['grad_bwd' + sfx]:.3f} "
              f"ms, on {fresnel_ms:.3f} ms")
    if want_attr:
        res["bucket"] = dict(ms=bucket_ms, bound_ms=bucket_bound[1] * 1e3,
                             index_add_ms=bucket_lib_ms, rows=bucket_rows_n, ratio=bucket_ratio)
    for k in ms:
        print(f"kernel {k} at {cfg.width}x{cfg.height}x{spp}spp: {ms[k]:.3f} ms per launch, bound "
              f"{res['bound_ms'][k]:.3f} ms ({res['bound_by'][k]}), "
              f"{res['bound_ms'][k] / ms[k]:.3f} of bound")
    if want_attr:
        bk = res["bucket"]
        print(f"bucket of the fused route: {bk['ms']:.3f} ms over {depth} launches, bound "
              f"{bk['bound_ms']:.3f} ms (bytes), index_add_ {bk['index_add_ms']:.3f} ms")
    return res


def raygen_main(tpt, fg, lib, cam, cfg, key, rows):
    """Raygen (row 8) at the fused route's launch, every pixel of the frame x
    FUSED_SPP samples: CUDA-event ms through ``_raygen_launch`` on the int64
    ids of ``ray_keys`` (two int32 casts included), on the int32 ids
    the route passes it, and of ``spt_raygen`` alone (ids and output made
    once); the scalar instantiation alone at the same launch (the pixel ids
    one element off 16-byte alignment, which the host reads as its cue);
    SASS per ray by pipe, ptxas, and both bounds.  Holds raygen bit for bit
    against its plain version on the rays ``rows``, on the first n - 1 rays
    (n % 4 != 0), on the last pixel ids of the frame, and at a width that is
    not a power of two with ids up to 2^31 - 1.  Raises on a mismatch."""
    from simplepathtracer_tpu_torch.ops.cuda_build import stream
    from simplepathtracer_tpu_torch.ops.persistent import camera_constants
    from simplepathtracer_tpu_torch.ops.sampling import ray_keys

    t0 = time.perf_counter()
    dev = cam.origin.device
    w, h = cfg.width, cfg.height
    keys = fused_keys(w, h, FUSED_SPP, key, dev)
    n = keys.pixel.shape[0]
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    keys32 = keys._replace(pixel=pix, sample=samp)
    cam19 = camera_constants(cam, w, h).detach().contiguous()
    out, out_scalar = torch.empty((6, n), device=dev), torch.empty((6, n), device=dev)
    pix_off = torch.empty(n + 1, dtype=torch.int32, device=dev)[1:]
    pix_off.copy_(pix)

    def launch(p_ids, o):
        if lib.lib.spt_raygen(n, cam19.data_ptr(), keys.k0, keys.k1, p_ids.data_ptr(),
                              samp.data_ptr(), w, fg._f32(1.0 / w), fg._f32(1.0 / h),
                              o.data_ptr(), stream(dev)) != 0:
            raise RuntimeError("raygen: spt_raygen failed to launch")

    res = {"ms": cuda_ms(lambda: fg._raygen_launch(cam19, keys, w, h), reps=10),
           "ms_int32_ids": cuda_ms(lambda: fg._raygen_launch(cam19, keys32, w, h), reps=10),
           "ms_kernel_alone": cuda_ms(lambda: launch(pix, out), reps=20),
           "ms_scalar_path_alone": cuda_ms(lambda: launch(pix_off, out_scalar), reps=20)}
    sync(dev)

    want = fg.raygen_reference(cam, sub_keys(keys, rows), cfg)
    checks = {"rows": torch.equal(out[:, rows], want), "scalar_path": torch.equal(out_scalar, out)}
    tail = sub_keys(keys, slice(0, n - 1))
    got = fg.raygen(cam, tail, cfg)
    pick = torch.cat([rows[rows < n - 1], torch.arange(n - 65, n - 1, device=dev)])
    checks["n_minus_1"] = torch.equal(got[:, pick], fg.raygen_reference(cam, sub_keys(tail, pick), cfg))
    p = w * h
    last = ray_keys(key, torch.arange(p - 4096, p, device=dev).repeat(2),
                    torch.arange(2, device=dev).repeat_interleave(4096))
    checks["last_pixel_ids"] = torch.equal(fg.raygen(cam, last, cfg), fg.raygen_reference(cam, last, cfg))
    wide = cfg.replace(width=46337, height=46345)
    top = ray_keys(key, torch.arange(2**31 - 4096, 2**31, device=dev),
                   torch.zeros(4096, dtype=torch.int64, device=dev))
    checks["width_46337_ids_to_2^31"] = torch.equal(fg.raygen(cam, top, wide),
                                                    fg.raygen_reference(cam, top, wide))
    res["checks"] = checks
    res["max_abs_err"] = (out[:, rows] - want).abs().max().item()
    del out_scalar

    # The bounds, from the work the function needs: bytes (each id read
    # once, each plane written once) and operations (RAYGEN_OPS, integer at
    # half the FP32 lanes' rate); the larger sets row 8's bound.  The SASS
    # per ray of the instantiation this launch runs (each thread makes
    # RAYGEN_RAYS_PER_THREAD rays) is printed beside them, not used in them.
    t_sass = time.perf_counter()
    hot = sass_hot_path(sass_kernel(lib.path, lib.log, "raygen_kernelILb1"))
    t_sass = time.perf_counter() - t_sass
    per_ray = {k: v / RAYGEN_RAYS_PER_THREAD for k, v in sass_counts(hot).items()}
    lanes = PEAK_FP32 / 2
    ops_s = max(RAYGEN_OPS["integer"] / (lanes / 2), sum(RAYGEN_OPS.values()) / lanes)
    res.update(sass_per_ray=per_ray, ops_per_ray=RAYGEN_OPS, bound_ops_ms=n * ops_s * 1e3,
               bound_bytes_ms=n * RAYGEN_BYTES / PEAK_BYTES * 1e3, n_rays=n,
               ptxas=ptxas_usage(lib.log, "raygen_kernelILb1"),
               ptxas_scalar=ptxas_usage(lib.log, "raygen_kernelILb0"))
    res["bound_ms"] = max(res["bound_ops_ms"], res["bound_bytes_ms"])
    res["bound_by"] = "operations" if res["bound_ops_ms"] >= res["bound_bytes_ms"] else "bytes"
    print(f"raygen at {w}x{h}x{FUSED_SPP}spp ({n} rays): through _raygen_launch {res['ms']:.4f} ms "
          f"(int64 ids, two casts; int32 ids {res['ms_int32_ids']:.4f}), alone "
          f"{res['ms_kernel_alone']:.4f} ms, scalar path alone {res['ms_scalar_path_alone']:.4f} ms; "
          f"ptxas {res['ptxas']} (scalar {res['ptxas_scalar']}); SASS per ray {json.dumps(per_ray)}; "
          f"bounds: bytes {res['bound_bytes_ms']:.4f} ms, operations {res['bound_ops_ms']:.4f} ms "
          f"({json.dumps(RAYGEN_OPS)} per ray, integer at half rate) -> "
          f"{res['bound_ms'] / res['ms_kernel_alone']:.3f} of bound alone; bit-exact {checks}; "
          f"{time.perf_counter() - t0:.1f} s ({t_sass:.1f} s of it cuobjdump)")
    if not all(checks.values()):
        raise RuntimeError(f"raygen disagrees with its plain version: {checks}")
    return res


def phase8_fused_route(tpt, dev, wrappers, lib):
    """The fused scene-leaf route at bench.py's shape: value_and_grad of
    pixel_loss on the cover frame at 8 spp in one chunk, hard, through the
    raygen kernel, the fused forward and backward and the buckets; held
    against the regeneration route on the same key, and each kernel at this
    shape on random rays.  Returns what the report needs."""
    from simplepathtracer_tpu_torch.ops import bucket, grad as fg

    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    fcfg = cfg.replace(use_pallas=False, use_pallas_grad=True, grad_regen=False, spp=FUSED_SPP,
                       spp_chunk=FUSED_SPP)
    rcfg = fcfg.replace(grad_regen=True)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, cfg.replace(spp=FUSED_SPP), tpt.fold_in(key, 1000))
    start = scene.replace(albedo=scene.albedo * ALBEDO_START, sky_lo=scene.sky_lo * SKY_START,
                          sky_hi=scene.sky_hi * SKY_START)
    loss_and_grads(tpt, start, target, cam, fcfg, key, dev)
    sync(dev)
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    for _ in range(FUSED_STEPS):
        l_f, g_f = loss_and_grads(tpt, start, target, cam, fcfg, key, dev)
    sync(dev)
    out = {"step_s": (time.perf_counter() - t0) / FUSED_STEPS, "peak_gb": peak_gb(dev)}
    launches = launch_counts()
    calls = plain_calls(wrappers)
    out["launches"] = launches
    per_step = {k: v / FUSED_STEPS for k, v in launches.items()}
    want = {"raygen": 1, "grad_fwd": cfg.max_depth, "grad_bwd": cfg.max_depth,
            "bucket": cfg.max_depth}
    paths = cfg.num_pixels * FUSED_SPP
    print(f"phase8 fused scene-leaf route, cover {cfg.width}x{cfg.height}x{FUSED_SPP}spp in one "
          f"chunk, depth {cfg.max_depth}, hard: value_and_grad {out['step_s']:.4f} s, "
          f"{paths / out['step_s'] / 1e6:.2f} Mpaths/s fwd+bwd, peak {out['peak_gb']:.2f} GB, "
          f"launches per step {per_step}, plain calls {calls}")
    if per_step != want or any(calls.values()):
        raise RuntimeError(f"phase8: the fused route did not run through its kernels only "
                           f"(launches per step {per_step}, wanted {want}, plain calls {calls})")

    # Against the regeneration route on the same key: the same paths (same
    # rays, same bounce code), summed in another order.
    l_r, g_r = loss_and_grads(tpt, start, target, cam, rcfg, key, dev)
    smooth = ("albedo", "sky_lo", "sky_hi")
    ok, worst = grads_close([g_f[k] for k in smooth], [g_r[k] for k in smooth])
    _, worst_all = grads_close(list(g_f.values()), list(g_r.values()))
    rel = abs(l_f.item() - l_r.item()) / abs(l_r.item())
    with torch.no_grad():
        img_f = tpt.render_linear(start, cam, fcfg, key)
        img_r = tpt.render_linear(start, cam, rcfg, key)
    d = (img_f - img_r).abs()
    share = (d > 1e-4).float().mean().item()
    out.update(loss_rel=rel, smooth_grad_err=worst, radiance_share=share)
    print(f"phase8 fused route vs regen route, same key: loss {l_f.item():.9g} vs "
          f"{l_r.item():.9g} (rel {rel:.2e}), albedo and sky gradients max|d| {worst:.3e} "
          f"(every leaf {worst_all:.3e}), radiance max|d| {d.max().item():.3e}, channels "
          f"|d| > 1e-4: {share:.5f} (bound {KNIFE_EDGE_SHARE})")
    if not (ok and rel <= 1e-6 and share < KNIFE_EDGE_SHARE):
        raise RuntimeError("phase8: the fused route disagrees with the regeneration route")

    gen = torch.Generator().manual_seed(10)
    rows = torch.randperm(paths, generator=gen)[:N_CHECK_PIXELS].to(dev)
    out.update(fused_full_width(tpt, fg, bucket, start, cam, fcfg, key, FUSED_SPP, rows, True))
    out["raygen"] = raygen_main(tpt, fg, lib, cam, fcfg, key, rows)
    return out


def camera_adfd(tpt, dev, scene, target, start, cfg, key, per_coordinate=True):
    """The camera gradient the fit steps along -- the decoupled loss's, at
    ``start`` with ``key`` -- against central differences (CAM_FD_EPS) of
    the loss's value on the frame ``cfg``: in each of the 7 camera
    coordinates, or with ``per_coordinate`` False along the gradient's own
    direction only (the slope a step against it descends).  The
    differences move the camera of every sample under the same random
    numbers, so they are smooth; the gradient is a Monte Carlo estimate
    that noise and the estimator's own bias (the specular BSDF-coin and
    knife edges it carries no term for) can turn in its weak coordinates.
    Returns the coordinates' names, AD, FD and, per coordinate, the
    cosine of AD and FD."""
    params, cam0 = tpt.split_camera(start)
    names = [f"{k}[{j}]" for k, v in params.items() for j in range(v.numel())]
    flat = torch.cat([v.reshape(-1) for v in params.values()])

    def unflat(x):
        out, i = {}, 0
        for k, v in params.items():
            out[k] = x[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
        return out

    def loss(p, decoupled):
        return tpt.camera_pixel_loss(p, cam0, scene, target, cfg, key, decoupled=decoupled,
                                     device=dev)

    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    ad = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss(p, True), list(p.values()))])
    dirs = torch.eye(flat.numel(), device=flat.device) if per_coordinate else (ad / ad.norm())[None]
    with torch.no_grad():
        fd = torch.stack([(loss(unflat(flat + CAM_FD_EPS * u), False)
                           - loss(unflat(flat - CAM_FD_EPS * u), False)) / (2 * CAM_FD_EPS)
                          for u in dirs])
    out = {"names": names, "ad": ad.tolist(), "fd": fd.tolist()}
    if per_coordinate:
        out["cos"] = (ad @ fd / (ad.norm() * fd.norm())).item()
    return out


def print_camera_adfd(tag, r):
    pairs = ", ".join(f"{n} {a:+.3e}/{f:+.3e}" for n, a, f in zip(r["names"], r["ad"], r["fd"]))
    print(f"{tag}: AD/FD per coordinate {pairs}; cos(AD, FD) {r['cos']:.3f}")


def camera_sign_check(r):
    """True when every coordinate whose difference is at least
    CAM_SIGN_SHARE of the largest has the gradient's sign."""
    ad, fd = torch.tensor(r["ad"]), torch.tensor(r["fd"])
    strong = fd.abs() >= CAM_SIGN_SHARE * fd.abs().max()
    return bool((torch.sign(ad)[strong] == torch.sign(fd)[strong]).all())


def phase8_fit_camera(tpt, dev, wrappers, extra_adfd=False):
    """The slice's main path: fit_camera on the full cover frame with its
    defaults (softness 0.02, the decoupled loss, leaves origin, lookat,
    vfov_deg) from an offset camera, through the fused kernels only; then
    each soft fused kernel at that fit's launch shape on random rays."""
    from simplepathtracer_tpu_torch.ops import bucket, grad as fg

    lap()
    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    soft_cfg = tpt.grad_safe_config(cfg.replace(silhouette_softness=DEFAULT_SOFTNESS), dev)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, soft_cfg, tpt.fold_in(key, 1000))
    start = cam.replace(origin=cam.origin + torch.tensor(CAM_ORIGIN_START, device=dev),
                        vfov_deg=cam.vfov_deg + CAM_VFOV_START)
    tpt.fit_camera(scene, target, start, cfg, key, steps=1, device=dev)
    sync(dev)
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit_camera(scene, target, start, cfg, key, steps=FIT_STEPS, device=dev)
    sync(dev)
    out = {"step_s": (time.perf_counter() - t0) / FIT_STEPS, "peak_gb": peak_gb(dev),
           "losses": losses}
    launches, calls = launch_counts(), plain_calls(wrappers)
    gcfg = tpt.grad_safe_config(cfg.replace(silhouette_softness=DEFAULT_SOFTNESS,
                                            camera_grad=True), dev)
    chunk, n = decoupled_chunks(cfg, gcfg)
    want = {"grad_fwd_soft": 2 * n * cfg.max_depth, "grad_bwd_soft": n * cfg.max_depth,
            "camera_jitter": 2 * n}

    def errors(c):
        return {"origin": (c.origin - cam.origin).norm().item(),
                "lookat": (c.lookat - cam.lookat).norm().item(),
                "vfov_deg": (c.vfov_deg - cam.vfov_deg).abs().item()}

    out.update(chunk=chunk, n_chunks=n, per_step=want, cam_err=(errors(start), errors(fitted)),
               launches=launches)
    print(f"phase8 fit_camera, cover {cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}, "
          f"defaults (softness {DEFAULT_SOFTNESS}, decoupled loss, leaves "
          f"{list(tpt.CAMERA_LEAVES)}; {cfg.spp // 2} spp differentiated in {n} chunk(s) of "
          f"{chunk}), {FIT_STEPS} steps: losses {losses}, {out['step_s']:.3f} s/step, "
          f"{cfg.num_pixels * cfg.spp / out['step_s'] / 1e6:.2f} Mpaths/s, peak "
          f"{out['peak_gb']:.2f} GB; camera error {out['cam_err'][0]} -> {out['cam_err'][1]}; "
          f"launches {launches}, plain calls {calls}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise RuntimeError("phase8: the camera fit's loss did not fall")
    if launches != {k: v * FIT_STEPS for k, v in want.items()} or any(calls.values()):
        raise RuntimeError(f"phase8: the camera fit did not run through the fused kernels only "
                           f"(launches {launches}, per step wanted {want}, plain calls {calls})")

    # The fit's gradient at the start camera against central differences of
    # the loss: stepping against it must lower the loss; and on a Lambertian
    # control (every material diffuse, the same geometry, camera, frame and
    # key), where the estimator has no specular edges to miss, each strong
    # coordinate must have the sign of its difference.
    lap("phase8c fit_camera")
    kcfg = cfg.replace(silhouette_softness=DEFAULT_SOFTNESS)
    r = camera_adfd(tpt, dev, scene, target, start, kcfg, tpt.fold_in(key, 0),
                    per_coordinate=False)
    ad_norm = math.sqrt(sum(a * a for a in r["ad"]))
    print(f"phase8 camera gradient at the start, cover {cfg.width}x{cfg.height}x{cfg.spp}spp: "
          f"|AD| {ad_norm:.4e}, slope of the loss along it (central FD, eps {CAM_FD_EPS}) "
          f"{r['fd'][0]:+.4e}")
    lap("phase8c descent check")
    lam = scene.replace(material=torch.zeros_like(scene.material))
    with torch.no_grad():
        target_l = tpt.render_linear(lam, cam, soft_cfg, tpt.fold_in(key, 1000))
    r_l = camera_adfd(tpt, dev, lam, target_l, start, kcfg, tpt.fold_in(key, 0))
    print_camera_adfd("phase8 camera gradient at the start, Lambertian control", r_l)
    out["camera_adfd"] = {"ad_norm": ad_norm, "fd_slope": r["fd"][0], "lambertian": r_l}
    lap("phase8c Lambertian control")
    if not (r["fd"][0] > 0.0 and camera_sign_check(r_l)):
        raise RuntimeError("phase8: the camera fit's gradient does not descend the loss, or a "
                           "strong coordinate has the wrong sign on the Lambertian control")
    if extra_adfd:
        # The main path's coordinates, on the fit's first key and another.
        for label, k in (("fold_in(key, 0)", tpt.fold_in(key, 0)), ("make_key(5)", tpt.make_key(5))):
            r = camera_adfd(tpt, dev, scene, target, start, kcfg, k)
            print_camera_adfd(f"phase8 camera gradient at the start, cover, key {label}", r)
            out["camera_adfd"].setdefault("cover", []).append(r)

    gen = torch.Generator().manual_seed(11)
    rows = torch.randperm(cfg.num_pixels * chunk, generator=gen)[:N_CHECK_PIXELS].to(dev)
    out.update(fused_full_width(tpt, fg, bucket, scene, cam, kcfg, key, chunk, rows, False))
    return out


def phase8_adfd(tpt, dev, wrappers):
    """AD/FD of vfov_deg through the fused kernels, in the setup of
    tests/test_camera_grad.py:21-52 (Lambertian three_sphere, 48x24, 256
    spp, depth 3, soft 0.05, eps 0.05)."""
    scene = tpt.three_sphere_scene(hollow_glass=False, device=dev)
    scene = scene.replace(material=torch.zeros_like(scene.material))
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device=dev)
    cfg = tpt.RenderConfig(width=48, height=24, spp=256, max_depth=3, silhouette_softness=0.05,
                           use_pallas_grad=True, grad_regen=False)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam.replace(vfov_deg=torch.tensor(62.0, device=dev)),
                                   cfg, tpt.make_key(99))
    params, cam0 = tpt.split_camera(cam)
    reset_counts()

    def loss(p):
        return tpt.camera_pixel_loss(p, cam0, scene, target, cfg, tpt.make_key(3), device=dev)

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    (g,) = torch.autograd.grad(loss(p), [p["vfov_deg"]])
    eps = VFOV_ADFD_EPS
    with torch.no_grad():
        fd = (loss(dict(params, vfov_deg=params["vfov_deg"] + eps)).item()
              - loss(dict(params, vfov_deg=params["vfov_deg"] - eps)).item()) / (2 * eps)
    ad = g.item()
    ratio = ad / fd if fd else float("nan")
    launches, calls = launch_counts(), plain_calls(wrappers)
    print(f"phase8 AD/FD of vfov_deg (Lambertian three_sphere 48x24, 256 spp, depth 3, soft 0.05, "
          f"eps {eps}): AD {ad:.6e}, FD {fd:.6e}, AD/FD {ratio:.4f} (bound {VFOV_ADFD_BOUNDS}); "
          f"launches {launches}, plain calls {calls}")
    if not (VFOV_ADFD_BOUNDS[0] <= ratio <= VFOV_ADFD_BOUNDS[1]
            and launches.get("grad_bwd_soft", 0) > 0
            and set(launches) <= {"grad_fwd_soft", "grad_bwd_soft", "raygen", "camera_jitter"}
            and not any(calls.values())):
        raise RuntimeError("phase8: AD/FD of vfov through the fused kernels out of its bound")
    return {"ad": ad, "fd": fd, "ratio": ratio}


def phase8_readme_example(tpt, dev):
    """README.md's fit_camera example as written there (three_sphere at
    96x48x8 spp, the origin moved by (0.06, -0.05, 0) and fitted back in 40
    steps, lr 8e-3, the origin alone): the origin's error must fall."""
    scene, cam, cfg = tpt.PRESETS["three_sphere"].build(0, device=dev)
    cfg = cfg.replace(width=96, height=48, spp=8)
    soft = tpt.grad_safe_config(cfg.replace(silhouette_softness=0.02), dev)
    target = tpt.render_linear(scene, cam, soft, tpt.make_key(9))
    start = cam.replace(origin=cam.origin + torch.tensor([0.06, -0.05, 0.0], device=dev))
    t0 = time.perf_counter()
    fitted, losses = tpt.fit_camera(scene, target, start, cfg, tpt.make_key(0), steps=40,
                                    lr=8e-3, leaves=("origin",), device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    err0 = (start.origin - cam.origin).norm().item()
    err1 = (fitted.origin - cam.origin).norm().item()
    print(f"phase8 README fit_camera example (three_sphere 96x48x8spp, 40 steps): losses "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, origin error {err0:.4f} -> {err1:.4f}, "
          f"{seconds:.2f} s")
    if not (all(map(math.isfinite, losses)) and err1 < err0):
        raise RuntimeError("phase8: the README's fit_camera example did not move the origin "
                           "toward the truth")
    return {"losses": [losses[0], losses[-1]], "origin_error": [err0, err1], "seconds": seconds}


def phase8_camera_jitter(tpt, dev, lib):
    """The camera-jitter kernel (csrc/camera_jitter.cu) at the camera fit's
    launch: fit_camera's defaults on the cover frame differentiate every
    pixel x 50 samples in one chunk, and each half of the decoupled loss
    draws that chunk's camera uniforms once (48 M rays; here samples 50-99,
    the differentiated half's).  Holds the kernel's uniforms bit for bit
    against the plain version's on every ray; on the first n - 1 rays (a
    ragged last tile); and on the frame's last pixel ids with the last
    sample ids and key words with their high bits set.  Times
    ``camera_jitter`` (its output allocated per call), ``spt_camera_jitter``
    alone and the plain version, with CUDA events; ptxas and both bounds.  Raises on a mismatch or on a launch count other
    than one per call."""
    from simplepathtracer_tpu_torch.ops import sampling as ts
    from simplepathtracer_tpu_torch.ops.cuda_build import stream

    t0 = time.perf_counter()
    cfg = tpt.PRESETS["cover"].config
    gcfg = tpt.grad_safe_config(cfg.replace(silhouette_softness=DEFAULT_SOFTNESS,
                                            camera_grad=True), dev)
    chunk, _ = decoupled_chunks(cfg, gcfg)
    p = cfg.num_pixels
    keys = ts.ray_keys(tpt.fold_in(tpt.make_key(0), 0), torch.arange(p, device=dev).repeat(chunk),
                       (chunk + torch.arange(chunk, device=dev)).repeat_interleave(p))
    n = keys.pixel.shape[0]
    reset_counts()
    got = ts.camera_jitter(keys)
    sync(dev)
    one_launch = launch_counts() == {"camera_jitter": 1}
    want = ts.camera_jitter_reference(keys)
    checks = {"every_ray": torch.equal(got, want), "one_launch": one_launch}
    max_err = (got - want).abs().max().item()
    del want
    tail = ts.camera_jitter(sub_keys(keys, slice(0, n - 1)))
    checks["n_minus_1"] = torch.equal(tail, got[:n - 1])
    del tail
    last = ts.ray_keys(torch.tensor([0xFFFFFFFF, 0x80000001]),
                       torch.arange(p - 4099, p, device=dev).repeat(2),
                       (2**24 - 1 - torch.arange(2, device=dev)).repeat_interleave(4099))
    checks["last_ids_high_key_bits"] = torch.equal(ts.camera_jitter(last),
                                                   ts.camera_jitter_reference(last))

    out = torch.empty((n, 4), device=dev)

    def launch():
        if lib.lib.spt_camera_jitter(n, keys.k0, keys.k1, keys.pixel.data_ptr(),
                                     keys.sample.data_ptr(), out.data_ptr(), stream(dev)) != 0:
            raise RuntimeError("camera jitter: spt_camera_jitter failed to launch")

    res = {"ms": cuda_ms(lambda: ts.camera_jitter(keys), reps=10),
           "ms_kernel_alone": cuda_ms(launch, reps=20),
           "plain_ms": cuda_ms(lambda: ts.camera_jitter_reference(keys), reps=2)}
    sync(dev)
    checks["alone"] = torch.equal(out, got)
    del out, got
    lanes = PEAK_FP32 / 2
    ops_s = max(CAMERA_JITTER_OPS["integer"] / (lanes / 2), sum(CAMERA_JITTER_OPS.values()) / lanes)
    res.update(checks=checks, max_abs_err=max_err, n_rays=n, ops_per_ray=CAMERA_JITTER_OPS,
               bound_ops_ms=n * ops_s * 1e3,
               bound_bytes_ms=n * CAMERA_JITTER_BYTES / PEAK_BYTES * 1e3,
               ptxas=ptxas_usage(lib.log, "camera_jitter_kernel"))
    res["bound_ms"] = max(res["bound_ops_ms"], res["bound_bytes_ms"])
    res["bound_by"] = "operations" if res["bound_ops_ms"] >= res["bound_bytes_ms"] else "bytes"
    print(f"phase8 camera jitter at {cfg.width}x{cfg.height}x{chunk}spp ({n} rays): through "
          f"camera_jitter {res['ms']:.4f} ms, alone {res['ms_kernel_alone']:.4f} ms, plain "
          f"{res['plain_ms']:.3f} ms; ptxas {res['ptxas']}; bounds: bytes "
          f"{res['bound_bytes_ms']:.4f} ms, operations {res['bound_ops_ms']:.4f} ms "
          f"({json.dumps(CAMERA_JITTER_OPS)} per ray, integer at half rate) -> "
          f"{res['bound_ms'] / res['ms_kernel_alone']:.3f} of bound alone; bit-exact {checks}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(checks.values()):
        raise RuntimeError(f"the camera-jitter kernel disagrees with its plain version: {checks}")
    return res


def explicit_cases(tpt, dev):
    """(name, scene, camera, width, height, spp, depth, rr) of phase 9's
    small shapes."""
    def trio_cam():
        return tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device=dev)

    trio = tpt.three_sphere_scene(hollow_glass=True, device=dev)
    return [
        ("three_sphere", trio, trio_cam(), 48, 24, 8, 10, 0),
        ("three_sphere_plane", tpt.with_ground_plane(trio), trio_cam(), 48, 24, 8, 10, 2),
        ("cover", tpt.compact_scene(tpt.cover_scene(0, device=dev)),
         tpt.PRESETS["cover"].camera_fn(dev), 64, 32, 4, 10, 0),
    ]


def camera_rays(cam, keys, width, height):
    """The eager camera rays render_pixels makes for ``keys``."""
    from simplepathtracer_tpu_torch.camera import generate_rays
    from simplepathtracer_tpu_torch.ops.sampling import camera_jitter

    return generate_rays(cam, width, height, keys.pixel, camera_jitter(keys))


def phase9_kernels(tpt, dev):
    """The bounce-step and closest-hit kernels against their plain versions
    at small shapes: every bounce of a trace, and on each bounce's rays both
    closest-hit kernels, bit for bit; trace_rays_pallas through the kernel
    against the same route through the plain version.  Returns ({kernel:
    max |d|}, {kernel: plain ms per launch}, {kernel: kernel ms per launch},
    {kernel: shape of those times})."""
    from simplepathtracer_tpu_torch.ops import bounce_step as bs
    from simplepathtracer_tpu_torch.ops import closest_hit as ch
    from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs
    from simplepathtracer_tpu_torch.render import bounce_step_call, trace_rays_pallas

    errs = {name: 0.0 for name, _, _ in EXPLICIT_KERNELS}
    plain_ms, kernel_ms, shapes = {}, {}, {}
    key = tpt.make_key(1)
    for name, scene, cam, w, h, spp, depth, rr in explicit_cases(tpt, dev):
        cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr,
                               use_pallas=True)
        tag = f"phase9 {name} {w}x{h}x{spp}spp depth {depth} rr {rr}"
        keys = fused_keys(w, h, spp, key, dev)
        o, d = camera_rays(cam, keys, w, h)
        call = bounce_step_call(scene, keys, cfg)
        tables = tuple(t.contiguous() for t in scene_inputs(scene)[:11])
        pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
        state = bs.initial_state(o, d)
        ok, live = True, []
        for b in range(depth):
            nxt = bs.bounce_step(call, state, pix, samp, b)
            sync(dev)
            want = bs.bounce_step_reference(call, state, pix, samp, b)
            ok = ok and torch.equal(nxt, want)
            errs["bounce_step"] = max(errs["bounce_step"], (nxt - want).abs().max().item())
            ro, rd, alive = state[0:3].T.contiguous(), state[3:6].T.contiguous(), state[12] > 0
            live.append(int(alive.sum().item()))
            got = ch.closest_hit_attrs(ro, rd, alive, tables, cfg.t_min, cfg.t_max)
            want = ch.closest_hit_attrs_reference(ro, rd, alive, tables, cfg.t_min, cfg.t_max)
            a_k, a_p = torch.stack(got[1]), torch.stack(want[1])
            ok = ok and torch.equal(got[0], want[0]) and torch.equal(a_k, a_p) and torch.equal(
                got[2], want[2])
            errs["closest_hit_attrs"] = max(errs["closest_hit_attrs"],
                                            (a_k - a_p).abs().max().item())
            got = ch.closest_hit(ro, rd, alive, scene.centers, scene.radii, cfg.t_min, cfg.t_max)
            want = ch.closest_hit_reference(ro, rd, alive, scene.centers, scene.radii, cfg.t_min,
                                            cfg.t_max)
            ok = ok and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            errs["closest_hit"] = max(errs["closest_hit"], (got[1] - want[1]).abs().max().item())
            state = nxt
        with torch.no_grad():
            rad_k = trace_rays_pallas(o, d, keys, scene, cfg)
            with plain_route(EXPLICIT_ROUTE):
                rad_p = trace_rays_pallas(o, d, keys, scene, cfg)
        route_ok = torch.equal(rad_k, rad_p) and torch.equal(rad_k, state[9:12].T)
        print(f"{tag}: bounce step and both closest-hit kernels on every bounce's rays "
              f"{'bit-exact' if ok else 'DIFFER'} (live rays per bounce {live}); "
              f"trace_rays_pallas kernel vs plain route {'bit-exact' if route_ok else 'DIFFERS'}")
        if not (ok and route_ok and torch.isfinite(rad_k).all() and rad_k.max() > 0):
            raise RuntimeError(f"{tag}: a kernel disagrees with its plain version")

        if name == "cover":
            # Per-launch times at this shape, bounce 0 (every ray live).
            shape = f"{name} {w}x{h}x{spp}spp, bounce 0, per launch"
            st0 = bs.initial_state(o, d)
            al = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
            timed = [
                ("bounce_step", lambda: bs.bounce_step(call, st0, pix, samp, 0),
                 lambda: bs.bounce_step_reference(call, st0, pix, samp, 0)),
                ("closest_hit_attrs", lambda: ch.closest_hit_attrs(o, d, al, tables),
                 lambda: ch.closest_hit_attrs_reference(o, d, al, tables)),
                ("closest_hit", lambda: ch.closest_hit(o, d, al, scene.centers, scene.radii),
                 lambda: ch.closest_hit_reference(o, d, al, scene.centers, scene.radii)),
            ]
            for kname, kern, plain in timed:
                plain_ms[kname] = cuda_ms(plain, reps=2)
                kernel_ms[kname] = cuda_ms(kern, reps=5)
                shapes[kname] = shape
                print(f"phase9 {shape}: {kname} plain {plain_ms[kname]:.3f} ms, kernel "
                      f"{kernel_ms[kname]:.3f} ms")
    return errs, plain_ms, kernel_ms, shapes


def phase9_explicit_forward(tpt, dev, wrappers):
    """Main path 1: render_pixels of the cover preset over every pixel x
    FUSED_SPP samples (7.68 M rays) through the bounce-step kernel.  Then
    the trace launch by launch at that shape: CUDA-event ms, live rays,
    bounds, and 2,048 random rays traced by the plain version alongside
    (bit for bit); and the per-pixel sums against the persistent kernel's
    for the same key and samples (the knife-edge bound, on the persistent
    kernel's own camera rays), with the share of paths that differ found by
    running each sample alone through the persistent kernel.  Returns what
    the report needs."""
    from simplepathtracer_tpu_torch.ops import bounce_step as bs
    from simplepathtracer_tpu_torch.ops.persistent import render_block_persistent
    from simplepathtracer_tpu_torch.render import _persistent_args, bounce_step_call

    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    spp, p, depth = FUSED_SPP, cfg.num_pixels, cfg.max_depth
    keys = fused_keys(cfg.width, cfg.height, spp, key, dev)
    n = keys.pixel.shape[0]
    small = fused_keys(64, 32, 1, key, dev)
    tpt.render_pixels(scene, cam, cfg, key, small.pixel, small.sample)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    rad = tpt.render_pixels(scene, cam, cfg, key, keys.pixel, keys.sample)
    sync(dev)
    out = {"s": time.perf_counter() - t0}
    launches, calls = launch_counts(), plain_calls(wrappers)
    out["launches"] = launches
    print(f"phase9 main path 1: render_pixels cover {cfg.width}x{cfg.height}x{spp}spp "
          f"({n} rays) depth {depth}, use_pallas: {out['s']:.4f} s, "
          f"{n / out['s'] / 1e6:.2f} Mpaths/s, launches {launches}, plain calls {calls}")
    if launches != {"bounce_step": depth, "camera_jitter": 1} or any(calls.values()):
        raise RuntimeError("phase9: render_pixels did not run through the bounce-step and "
                           "camera-jitter kernels only")
    if rad.shape != (n, 3) or not torch.isfinite(rad).all() or rad.max() <= 0:
        raise RuntimeError("phase9: render_pixels' radiance is not finite or is all zero")

    # Launch by launch, with 2,048 random rays traced by the plain version.
    o, d = camera_rays(cam, keys, cfg.width, cfg.height)
    call = bounce_step_call(scene, keys, cfg)
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(11))[:N_CHECK_PIXELS].to(dev)
    state = bs.initial_state(o, d)
    del o, d
    st_p = state[:, rows]
    s_live = live_spheres(scene)
    ms_b, bound, live, groups, ok, err = [], [0.0, 0.0], [], [], True, 0.0
    for b in range(depth):
        ms_b.append(cuda_ms(lambda: bs.bounce_step(call, state, pix, samp, b), reps=2))
        nxt = bs.bounce_step(call, state, pix, samp, b)
        alive = state[12] > 0
        n_live = int(alive.sum().item())
        live.append(n_live)
        # Groups of 32 consecutive rays holding a live ray: the warps that
        # scan when each thread takes one ray.
        groups.append(int(torch.cat([alive, alive.new_zeros((-n) % 32)]).view(-1, 32)
                          .any(dim=1).sum().item()))
        bound[0] += n_live * s_live * FLOPS_PER_SPHERE_TEST / PEAK_FP32 / depth
        bound[1] += n * BOUNCE_STEP_BYTES / PEAK_BYTES / depth
        got = bs.bounce_step_reference(call, st_p, pix[rows], samp[rows], b)
        ok = ok and torch.equal(nxt[:, rows], got)
        err = max(err, (nxt[:, rows] - got).abs().max().item())
        st_p, state = got, nxt
    ok = ok and torch.equal(state[9:12].T, rad)
    del state, nxt
    ms = sum(ms_b) / depth
    out.update(ms=ms, ms_per_bounce=ms_b, live=live, live_groups=groups, err=err,
               bound_ms=max(bound) * 1e3,
               bound_by="operations" if bound[0] >= bound[1] else "bytes")
    print(f"phase9 bounce step at {cfg.width}x{cfg.height}x{spp}spp: {ms:.3f} ms per launch "
          f"(mean over {depth}; per bounce {[round(x, 3) for x in ms_b]}), bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}), "
          f"{out['bound_ms'] / ms:.3f} of bound; live rays per bounce {live}; groups of 32 "
          f"rays holding a live ray per bounce {groups} of {-(-n // 32)} (sum over bounces "
          f"{sum(groups) / -(-n // 32):.3f} x the batch; live rays {sum(live) / n:.3f} x); "
          f"{N_CHECK_PIXELS} random rays against the plain version "
          f"{'bit-exact' if ok else 'DIFFER'}, the trace equals render_pixels' radiance")
    if not ok:
        raise RuntimeError("phase9: the bounce-step kernel disagrees with its plain version at "
                           "full width")

    # Against the persistent kernel: the same paths (key, pixels, samples)
    # in its own arithmetic (selects, not lerps).  Its camera rays are the
    # raygen kernel's (common.cuh:camera_ray, bit-exact in phase 8a), which
    # round otherwise than render_pixels' eager generate_rays: an ulp on
    # most rays, enough to flip a grazing path.  So the bound holds the
    # bounce-step trace of the persistent kernel's own rays; render_pixels'
    # paths are compared too and reported.
    from simplepathtracer_tpu_torch.ops import grad as fg
    from simplepathtracer_tpu_torch.render import trace_rays_pallas

    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    pix_all = torch.arange(p, device=dev)

    def persistent(sample_offset, n_samples):
        return render_block_persistent(pix_all, tables, sky6, cam19, key, sample_offset,
                                       n_samples, depth, cfg.width, cfg.height, t_min=cfg.t_min,
                                       t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth)

    rays = fg.raygen(cam, keys, cfg)
    with torch.no_grad():
        rad_r = trace_rays_pallas(rays[0:3].T, rays[3:6].T, keys, scene, cfg)
    del rays
    sums_q = persistent(0, spp)
    per_q = [persistent(s, 1) for s in range(spp)]
    stats = {}
    for name, r in (("raygen_rays", rad_r), ("render_pixels", rad)):
        per = r.reshape(spp, p, 3)
        dd = ((per.sum(dim=0) - sums_q) / spp).abs()
        flipped = sum(int(((per[s] - per_q[s]).abs().amax(dim=1) > FLIP_TOL).sum().item())
                      for s in range(spp))
        stats[name] = dict(mean=dd.mean().item(), share=(dd > 1e-4).float().mean().item(),
                           max=dd.max().item(), flipped_paths=flipped / n)
        print(f"phase9 explicit-ray forward ({name}) vs persistent kernel, per-pixel means over "
              f"{spp} spp: mean|d| {stats[name]['mean']:.3e}, share |d| > 1e-4 "
              f"{stats[name]['share']:.5f} (bound {KNIFE_EDGE_SHARE}), max|d| "
              f"{stats[name]['max']:.3e}; paths whose radiance differs by > {FLIP_TOL}: "
              f"{flipped} of {n} ({flipped / n:.2e})")
    out["vs_persistent"] = stats
    k = stats["raygen_rays"]
    if not (k["mean"] < 1e-4 and k["share"] < KNIFE_EDGE_SHARE):
        raise RuntimeError("phase9: the explicit-ray forward disagrees with the persistent kernel")
    return out


def phase9_hits_fit(tpt, dev, wrappers):
    """Main path 2: fit on the cover frame through the use_pallas_hits route
    (the preset's config with use_pallas off, spp FUSED_SPP, albedo and sky
    fitted from the phase-6 start): one warm step, FIT_STEPS timed, through
    the closest-hit-attributes and bucket kernels only.  Then the first
    step's value and gradient against the fused route on the same key, and
    the closest-hit-attributes kernel at each bounce of one chunk: CUDA-event
    ms, live rays, bounds, 2,048 random rays against the plain version.
    Returns what the report needs."""
    from simplepathtracer_tpu_torch.inverse import fit_config
    from simplepathtracer_tpu_torch.ops import bucket
    from simplepathtracer_tpu_torch.ops import closest_hit as ch
    from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs

    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    depth = cfg.max_depth
    hcfg = cfg.replace(use_pallas=False, use_pallas_hits=True, spp=FUSED_SPP)
    gcfg = fit_config(hcfg, dev)
    chunk = gcfg.spp_chunk or FUSED_SPP
    n_chunks = FUSED_SPP // chunk
    if not (gcfg.use_pallas_hits and not gcfg.use_pallas_grad and FUSED_SPP % chunk == 0):
        raise RuntimeError(f"phase9: fit does not take the hits route ({gcfg})")
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, cfg.replace(spp=FUSED_SPP), tpt.fold_in(key, 1000))
    start = scene.replace(albedo=scene.albedo * ALBEDO_START, sky_lo=scene.sky_lo * SKY_START,
                          sky_hi=scene.sky_hi * SKY_START)
    leaves = ("albedo", "sky_lo", "sky_hi")
    fit_kw = dict(lr=FIT_LR, softness=0.0, leaves=leaves, device=dev)
    tpt.fit(start, target, cam, hcfg, key, steps=1, **fit_kw)
    sync(dev)
    lap("phase9 (c) warm fit step")
    reset_counts()
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit(start, target, cam, hcfg, key, steps=FIT_STEPS, **fit_kw)
    sync(dev)
    out = {"step_s": (time.perf_counter() - t0) / FIT_STEPS, "peak_gb": peak_gb(dev),
           "losses": losses, "chunk": chunk, "n_chunks": n_chunks}
    out["launches"] = launch_counts()
    calls = plain_calls(wrappers)
    per_step = {k: v / FIT_STEPS for k, v in out["launches"].items()}
    out["per_step"] = per_step
    # With more than one chunk each chunk's forward runs twice
    # (render_pixel_block rematerializes it in the backward).  Its backward
    # buckets once per bounce but the last, whose attributes reach no output
    # (its hit point and direction are not read again).
    fwd_runs = 2 if n_chunks > 1 else 1
    want = {"closest_hit_attrs": fwd_runs * n_chunks * depth,
            "bucket": n_chunks * (depth - 1), "camera_jitter": fwd_runs * n_chunks}
    paths = cfg.num_pixels * FUSED_SPP
    print(f"phase9 main path 2: fit (use_pallas_hits) cover {cfg.width}x{cfg.height}x"
          f"{FUSED_SPP}spp depth {depth}, {n_chunks} chunks of {chunk} spp, {FIT_STEPS} steps: "
          f"losses {losses}, {out['step_s']:.4f} s/step, {paths / out['step_s'] / 1e6:.2f} "
          f"Mpaths/s fwd+bwd, peak {out['peak_gb']:.2f} GB, launches per step {per_step}, "
          f"plain calls {calls}")
    if per_step != want or any(calls.values()):
        raise RuntimeError(f"phase9: the hits fit did not run through its kernels only "
                           f"(launches per step {per_step}, wanted {want})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise RuntimeError("phase9: the hits fit's loss did not fall")
    lap("phase9 (c) fit")

    # The first step's value and gradient against the fused route (phase
    # 8b's, one chunk) on the same key and the same camera rays: the same
    # paths in other arithmetic (the fused bounce's hit rebuild).  camera_grad
    # gives the fused route render_pixels' eager rays in place of raygen's,
    # which round otherwise by an ulp on most rays and flip ~0.7% of paths
    # (phase 9b); the camera needs no gradient here.
    key0 = tpt.fold_in(key, 0)
    l_h, g_h = loss_and_grads(tpt, start, target, cam, hcfg, key0, dev, leaves=leaves)
    fcfg = cfg.replace(use_pallas=False, use_pallas_grad=True, grad_regen=False, spp=FUSED_SPP,
                       spp_chunk=FUSED_SPP, camera_grad=True)
    l_f, g_f = loss_and_grads(tpt, start, target, cam, fcfg, key0, dev, leaves=leaves)
    loss_rel = abs(l_h.item() - l_f.item()) / abs(l_f.item())
    grad_l2 = {k: ((g_h[k] - g_f[k]).norm() / g_f[k].norm()).item() for k in leaves}
    out.update(loss_rel=loss_rel, grad_l2=grad_l2)
    print(f"phase9 hits route vs fused route, first step's key: loss {l_h.item():.9g} vs "
          f"{l_f.item():.9g} (rel {loss_rel:.2e}, bound {HITS_LOSS_RTOL}), gradient relative L2 "
          f"{grad_l2} (bound {HITS_GRAD_L2}); the fit's first loss {losses[0]:.9g}")
    if not (loss_rel <= HITS_LOSS_RTOL and max(grad_l2.values()) <= HITS_GRAD_L2
            and losses[0] == l_h.item()):
        raise RuntimeError("phase9: the hits route disagrees with the fused route")
    lap("phase9 (c) against the fused route")

    # The closest-hit-attributes kernel at each bounce of chunk 0: record
    # the rays the route hands it, then time and check each launch.
    keys = fused_keys(cfg.width, cfg.height, chunk, key0, dev)
    n = keys.pixel.shape[0]
    tables = tuple(t.contiguous() for t in scene_inputs(start)[:11])
    kernel = ch.closest_hit_attrs
    recorded = []

    def record(o, d, alive, tabs, t_min, t_max, **kw):
        recorded.append((o, d, alive))
        return kernel(o, d, alive, tabs, t_min, t_max, **kw)

    ch.closest_hit_attrs = record
    try:
        with torch.no_grad():
            tpt.render_pixels(start, cam, gcfg, key0, keys.pixel, keys.sample)
    finally:
        ch.closest_hit_attrs = kernel
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(12))[:N_CHECK_PIXELS].to(dev)
    s_live = live_spheres(scene)
    # The bucket the backward runs on each bounce's winners (random
    # cotangents; the last bounce has none).
    ct = (torch.randn((9, n), generator=torch.Generator().manual_seed(14)) * 1e-6).to(dev)
    # The wrapper as the route calls it, on the table the trace builds once,
    # and with the table built in each call.
    tab = ch.sphere_table(tables)
    ms_b, ms_t, bucket_ms, bound, live, ok, err = [], [], [], [0.0, 0.0], [], True, 0.0
    for b, (o, d, alive) in enumerate(recorded):
        ms_b.append(cuda_ms(lambda: kernel(o, d, alive, tables, cfg.t_min, cfg.t_max, tab=tab),
                            reps=5))
        ms_t.append(cuda_ms(lambda: kernel(o, d, alive, tables, cfg.t_min, cfg.t_max), reps=5))
        got = kernel(o, d, alive, tables, cfg.t_min, cfg.t_max, tab=tab)
        if b + 1 < depth:
            bucket_ms.append(cuda_ms(lambda: bucket.bucket_cols(ct, got[0], scene.num_spheres),
                                     reps=10))
        want = ch.closest_hit_attrs_reference(o[rows], d[rows], alive[rows], tables, cfg.t_min,
                                              cfg.t_max)
        a_k, a_p = torch.stack(got[1])[:, rows], torch.stack(want[1])
        ok = ok and torch.equal(got[0][rows], want[0]) and torch.equal(a_k, a_p) and torch.equal(
            got[2][rows], want[2])
        err = max(err, (a_k - a_p).abs().max().item())
        n_live = int(alive.sum().item())
        live.append(n_live)
        bound[0] += n_live * s_live * FLOPS_PER_SPHERE_TEST / PEAK_FP32 / depth
        bound[1] += n * ATTRS_BYTES / PEAK_BYTES / depth
    del recorded
    ms = sum(ms_b) / depth
    kernels_s = (per_step["closest_hit_attrs"] * ms + per_step["bucket"] * sum(bucket_ms)
                 / len(bucket_ms)) / 1e3
    out.update(ms=ms, ms_per_bounce=ms_b, table_per_call_ms_per_bounce=ms_t,
               bucket_ms=bucket_ms, live=live, err=err, n_rays=n,
               bound_ms=max(bound) * 1e3, kernel_share=kernels_s / out["step_s"],
               bound_by="operations" if bound[0] >= bound[1] else "bytes")
    print(f"phase9 closest_hit_attrs at one chunk ({cfg.width}x{cfg.height}x{chunk}spp, {n} "
          f"rays): {ms:.3f} ms per launch (mean over {len(live)}; per bounce "
          f"{[round(x, 3) for x in ms_b]}; with the table built in each call "
          f"{[round(x, 3) for x in ms_t]}), bound {out['bound_ms']:.3f} ms "
          f"({out['bound_by']}), {out['bound_ms'] / ms:.3f} of bound; live rays per bounce "
          f"{live}; {N_CHECK_PIXELS} random rays against the plain version "
          f"{'bit-exact' if ok else 'DIFFER'}; bucket per bounce "
          f"{[round(x, 3) for x in bucket_ms]} ms; the step's launches take "
          f"{kernels_s:.4f} s of {out['step_s']:.4f} s ({out['kernel_share']:.3f})")
    if not (ok and len(live) == depth):
        raise RuntimeError("phase9: the closest-hit-attributes kernel disagrees with its plain "
                           "version at full width")
    return out


def grazing_cases(scene, dev):
    """(name, centers, radii, origins, dirs, alive) of the grazing ray sets
    the index-and-t kernel is held to bit for bit: tests/kernel_cases.py's
    grazing_rays on its AXIS_SPHERES (centered on the z axis, where
    tangency is exact) and on the cover scene, each with every, some and no
    ray alive."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from kernel_cases import AXIS_SPHERES, grazing_rays

    axis_c, axis_r = (torch.tensor(a, device=dev) for a in AXIS_SPHERES)
    out = []
    for name, c, r in (("axis", axis_c, axis_r), ("cover", scene.centers, scene.radii)):
        o, d = grazing_rays(c, r)
        n = o.shape[0]
        every = torch.ones(n, dtype=torch.bool, device=dev)
        some = torch.arange(n, device=dev) % 3 != 0
        for alive_name, alive in (("all", every), ("some", some), ("none", ~every)):
            out.append((f"{name}/{alive_name}", c, r, o, d, alive))
    return out


def phase9_closest_hit(tpt, dev, wrappers, lib):
    """intersect_scene_pallas (kernel 11) on the full frame's camera rays
    (one sample per pixel): launches, CUDA-event ms through the kernel's
    wrapper (which builds the sphere table) and of spt_closest_hit alone
    (on a table built once), bound, 2,048 random rays against the plain
    version, and the grazing ray sets bit for bit.  Returns what the report
    needs."""
    from simplepathtracer_tpu_torch.ops import closest_hit as ch
    from simplepathtracer_tpu_torch.ops import intersect
    from simplepathtracer_tpu_torch.ops.cuda_build import stream

    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    keys = fused_keys(cfg.width, cfg.height, 1, tpt.make_key(0), dev)
    o, d = camera_rays(cam, keys, cfg.width, cfg.height)
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    reset_counts()
    hit = intersect.intersect_scene_pallas(o, d, alive, scene, cfg.t_min, cfg.t_max)
    sync(dev)
    launches, calls = launch_counts(), plain_calls(wrappers)
    ms = cuda_ms(lambda: ch.closest_hit(o, d, alive, scene.centers, scene.radii,
                                        cfg.t_min, cfg.t_max), reps=5)
    # The kernel alone: the wrapper's table (cx, cy, cz, r^2) and outputs
    # made once, then only the launch.
    rad = scene.radii.detach()
    spheres = torch.cat([scene.centers.detach(), (rad * rad)[:, None]], 1).contiguous()
    oc, dc = o.contiguous(), d.contiguous()
    i_out = torch.empty(n, dtype=torch.int32, device=dev)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)

    def launch():
        if lib.lib.spt_closest_hit(n, spheres.data_ptr(), spheres.shape[0], oc.data_ptr(),
                                   dc.data_ptr(), alive.data_ptr(), float(cfg.t_min),
                                   float(cfg.t_max), i_out.data_ptr(), t_out.data_ptr(),
                                   stream(dev)) != 0:
            raise RuntimeError("phase9: spt_closest_hit failed to launch")

    alone_ms = cuda_ms(launch, reps=20)
    idx, t = ch.closest_hit(o, d, alive, scene.centers, scene.radii, cfg.t_min, cfg.t_max)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(13))[:N_CHECK_PIXELS].to(dev)
    i_p, t_p = ch.closest_hit_reference(o[rows], d[rows], alive[rows], scene.centers,
                                        scene.radii, cfg.t_min, cfg.t_max)
    ok = (torch.equal(idx[rows], i_p) and torch.equal(t[rows], t_p)
          and torch.equal(i_out, idx) and torch.equal(t_out, t)
          and torch.equal(hit.hit, idx >= 0) and bool(torch.isfinite(hit.t).all()))
    err = (t[rows] - t_p).abs().max().item()
    grazing = {}
    for name, c, rad, go, gd, galive in grazing_cases(scene, dev):
        gi, gt = ch.closest_hit(go, gd, galive, c, rad, cfg.t_min, cfg.t_max)
        wi, wt = ch.closest_hit_reference(go, gd, galive, c, rad, cfg.t_min, cfg.t_max)
        same = torch.equal(gi, wi) and torch.equal(gt, wt)
        grazing[name] = dict(rays=go.shape[0], hits=int((gi >= 0).sum().item()), exact=same)
        ok = ok and same
        err = max(err, (gt - wt).abs().max().item())
    s_live = live_spheres(scene)
    ops_s = n * s_live * FLOPS_PER_SPHERE_TEST / PEAK_FP32
    bytes_s = n * HIT_BYTES / PEAK_BYTES
    out = {"ms": ms, "ms_kernel_alone": alone_ms, "launches": launches, "err": err,
           "bound_ms": max(ops_s, bytes_s) * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes", "n_rays": n,
           "hit_share": (idx >= 0).float().mean().item(), "grazing": grazing}
    print(f"phase9 intersect_scene_pallas cover {cfg.width}x{cfg.height} camera rays ({n}), "
          f"{s_live} live spheres: launches {launches}, plain calls {calls}; closest_hit "
          f"{ms:.3f} ms through its wrapper (table built), {alone_ms:.3f} ms alone, bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}), {out['bound_ms'] / ms:.3f} of bound, "
          f"hits {out['hit_share']:.4f}; {N_CHECK_PIXELS} random rays and the grazing sets "
          f"{json.dumps(grazing)} against the plain version {'bit-exact' if ok else 'DIFFER'}")
    if launches != {"closest_hit": 1} or any(calls.values()) or not ok:
        raise RuntimeError("phase9: intersect_scene_pallas did not run through the closest-hit "
                           "kernel, or the kernel disagrees with its plain version")
    return out


# Phase 10, the command line: the cover preset through ``cli.main`` in this
# process.  Render chunks and snapshot cadence (spp), invert steps, the
# grad-accum groups; the balance measurement's steps per fit, and the share
# of step time by which fit(balance=True) must win in both rounds to be the
# CLI's default on CUDA; the fit snapshot check's steps and loss tolerance
# (fit's docstring: the bucket's atomics change the order of its sums).
CLI_CHUNK_SPP = 50
CLI_INVERT_STEPS, CLI_ACCUM_STEPS, CLI_ACCUM_GROUPS, CLI_DEMO_STEPS = 3, 2, 4, 4
BALANCE_STEPS, BALANCE_MIN_GAIN = 3, 0.03
SNAPSHOT_STEPS, SNAPSHOT_RTOL = 2, 1e-4


def run_cli(argv):
    """``cli.main(argv)`` in this process; returns the Meter's records (the
    JSON lines it writes to standard error).  A command that fails raises."""
    from simplepathtracer_tpu_torch import cli

    buf = StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"phase10: cli {argv} returned {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def records_of(recs, phase):
    return [r for r in recs if r["phase"] == phase]


def trace_kernels(path, name):
    """Device kernel events of a Chrome trace whose name holds ``name``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]


def route_counts(wrappers):
    """Launches of every kernel since the counts were reset (the persistent
    kernel's too) and the plain versions' calls."""
    since = counts_since_reset()
    got = launch_counts()
    if since["launch.persistent"]:
        got["persistent_render"] = since["launch.persistent"]
    calls = {k: n for k, n in plain_calls(wrappers).items() if n}
    if since["plain.render_block_persistent_reference"]:
        calls["persistent_render"] = since["plain.render_block_persistent_reference"]
    return got, calls



def cli_command(wrappers, argv, want, forbid=()):
    """Run one CLI command with every count set to 0 just before it; the
    kernels in ``want`` must have launched, those in ``forbid`` not, and no
    plain version may have run.  Returns (records, launches, seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    recs = run_cli(argv)
    seconds = time.perf_counter() - t0
    got, calls = route_counts(wrappers)
    missing = [k for k in want if not got.get(k)]
    if missing or calls or any(got.get(k) for k in forbid):
        raise RuntimeError(f"phase10: cli {argv} did not run through the kernels it needs "
                           f"(launches {got}, plain calls {calls}, missing {missing})")
    return recs, got, seconds


def phase10_cli(tpt, dev, wrappers, render_s):
    """The command line on the card at the cover preset's full width: (a) a
    traced render in two chunks with snapshots, (b) a render stopped and
    resumed, bit for bit against (a), (c) the preset invert, hard and soft
    phases, with fit snapshots, then the same command resuming from them
    and running no step, (d) the invert with the gradient-accumulated
    estimator and each group's peak memory, (e) the small invert demo
    (fused kernels), (f) fit(balance=True) against the unbalanced fit, (g)
    a fit snapshot's round trip and a resumed fit."""
    from simplepathtracer_tpu_torch import checkpoint, inverse

    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="spt_cli_")
    d = tmp.name
    regen = ("regen_fwd", "regen_refwd", "regen_bwd", "bucket")

    # (a) render --preset cover, traced, two chunks with snapshots.
    a_npz, a_bmp, trace_dir = (os.path.join(d, n) for n in ("A.npz", "a.bmp", "trace"))
    recs, got, sec = cli_command(wrappers, [
        "render", "--preset", "cover", "--snapshot-every", str(CLI_CHUNK_SPP),
        "--snapshot", a_npz, "-o", a_bmp, "--trace", trace_dir], ["persistent_render"])
    chunks = records_of(recs, "render")
    traced = trace_kernels(os.path.join(trace_dir, "trace.json"), "persistent_kernel<")
    paths = sum(r["paths"] for r in chunks)
    busy = sum(r["elapsed_s"] for r in chunks)
    done = records_of(recs, "done")[0]
    out["render"] = {
        "chunks": len(chunks), "launches": got["persistent_render"],
        "traced_persistent_kernels": len(traced),
        "traced_kernel_ms": [round(e["dur"] / 1e3, 3) for e in traced],
        "meter_paths_per_sec": paths / busy, "meter_elapsed_s": [r["elapsed_s"] for r in chunks],
        "render_s_phase3": render_s, "command_s": sec, "encoder": done["encoder"],
    }
    print(f"phase10 (a) cli render cover {done['spp']} spp in {len(chunks)} chunks (traced): Meter "
          f"{paths / busy / 1e6:.2f} Mpaths/s over {busy:.4f} s against phase 3's render() "
          f"{render_s:.4f} s ({paths / render_s / 1e6:.2f} Mpaths/s); command {sec:.2f} s; "
          f"persistent launches {got['persistent_render']}, in the trace {len(traced)} "
          f"({out['render']['traced_kernel_ms']} ms); BMP by the {done['encoder']} encoder")
    if len(chunks) != 2 or got["persistent_render"] != 2 or len(traced) != 2:
        raise RuntimeError("phase10 (a): the render did not launch the persistent kernel once "
                           "per chunk, or the trace does not show it")

    # (b) Stopped after 50 spp, resumed to 100: bit for bit the render of (a).
    b_npz, b_bmp = os.path.join(d, "B.npz"), os.path.join(d, "b.bmp")
    cli_command(wrappers, ["render", "--preset", "cover", "--spp", str(CLI_CHUNK_SPP),
                           "--snapshot", b_npz, "--snapshot-every", str(CLI_CHUNK_SPP),
                           "-o", os.path.join(d, "half.bmp")], ["persistent_render"])
    recs, got, _ = cli_command(wrappers, ["render", "--resume", b_npz, "--spp", "100",
                                          "--snapshot", b_npz, "-o", b_bmp],
                               ["persistent_render"])
    sa, sb = checkpoint.load(a_npz, device=dev)[0], checkpoint.load(b_npz, device=dev)[0]
    with open(a_bmp, "rb") as fa, open(b_bmp, "rb") as fb:
        same_file = fa.read() == fb.read()
    resumed = records_of(recs, "render")[0]
    out["resume"] = {"accum_equal": torch.equal(sa.accum, sb.accum), "bmp_equal": same_file,
                     "samples": [sa.sample_count, sb.sample_count],
                     "resumed_chunk_paths_per_sec": resumed["paths_per_sec"]}
    print(f"phase10 (b) resumed at 50 spp to 100: accum equal {out['resume']['accum_equal']}, "
          f"bmp byte-equal {same_file}; the resumed 50-spp chunk (untraced) "
          f"{resumed['paths_per_sec'] / 1e6:.2f} Mpaths/s")
    if not (out["resume"]["accum_equal"] and same_file and sa.sample_count == sb.sample_count == 100):
        raise RuntimeError("phase10 (b): the resumed render differs from the uninterrupted one")

    # (c) invert --preset cover with fit snapshots, then again: it resumes.
    prefix = os.path.join(d, "P")
    argv = ["invert", "--preset", "cover", "--steps", str(CLI_INVERT_STEPS), "--snapshot",
            prefix, "--snapshot-every", "1"]
    soft = ("regen_fwd_soft", "regen_refwd_soft", "regen_bwd_soft", "bucket_blocker")
    recs, got, sec = cli_command(wrappers, argv, ("persistent_render",) + regen + soft)
    inv = records_of(recs, "invert_done")[0]
    steps = {ph: records_of(recs, f"invert_{ph}_steps")[0] for ph in ("albedo", "centers")}
    print(f"phase10 (c) cli invert cover {inv['size']} {inv['spp']} spp: {sec:.2f} s, step s "
          f"albedo (hard) {steps['albedo']['step_s']}, centers (soft) "
          f"{steps['centers']['step_s']}; launches {got}")
    print(f"phase10 (c) invert_done {json.dumps(inv)}")
    pc = tpt.PRESETS["cover"].config
    if not (inv["size"] == f"{pc.width}x{pc.height}" and inv["spp"] == pc.spp
            and all(map(math.isfinite, (inv["loss_first"], inv["loss_last"])))
            and [s["steps_run"] for s in steps.values()] == [1, CLI_INVERT_STEPS - 1]):
        raise RuntimeError("phase10 (c): the preset invert did not run at full width with "
                           "finite losses")
    recs2, got2, sec2 = cli_command(wrappers, argv, ("persistent_render",),
                                    forbid=("regen_bwd", "regen_bwd_soft"))
    inv2 = records_of(recs2, "invert_done")[0]
    ran = [records_of(recs2, f"invert_{ph}_steps")[0]["steps_run"] for ph in ("albedo", "centers")]
    print(f"phase10 (c) the same command again: {sec2:.2f} s, steps run {ran}, same summary "
          f"{json.dumps(inv2) == json.dumps(inv)}; launches {got2}")
    if ran != [0, 0] or json.dumps(inv2) != json.dumps(inv):
        raise RuntimeError("phase10 (c): the invert did not resume from its snapshots")
    out["invert"] = {"s": sec, "step_s": {k: v["step_s"] for k, v in steps.items()},
                     "launches": got, "done": inv, "resume_s": sec2, "resume_launches": got2}

    # (d) The gradient-accumulated estimator, and each group's peak memory.
    recs, got, sec = cli_command(wrappers, [
        "invert", "--preset", "cover", "--steps", str(CLI_ACCUM_STEPS), "--grad-accum",
        str(CLI_ACCUM_GROUPS)], ("persistent_render",) + regen + soft)
    inv = records_of(recs, "invert_done")[0]
    acc_steps = {ph: records_of(recs, f"invert_{ph}_steps")[0]["step_s"]
                 for ph in ("albedo", "centers")}
    if not all(map(math.isfinite, (inv["loss_first"], inv["loss_last"]))):
        raise RuntimeError("phase10 (d): the grad-accum invert's losses are not finite")
    truth, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    cfg = inverse.fit_config(cfg.replace(rr_start_depth=2), dev)
    with torch.no_grad():
        target = tpt.render_linear(truth, cam, cfg, tpt.make_key(7))
    step = inverse.make_accum_grad_step(truth, target, cam, cfg, CLI_ACCUM_GROUPS, dev)
    params = {"albedo": truth.albedo * 0.8}
    ct = 2.0 * (step.image(params, tpt.make_key(8)) - target) / float(target.numel())
    groups = []
    for k in range(CLI_ACCUM_GROUPS):
        sync(dev)
        reset_peak(dev)
        t0 = time.perf_counter()
        g = step.group_grad(params, ct, tpt.make_key(9), k)
        sync(dev)
        groups.append({"s": round(time.perf_counter() - t0, 4), "peak_gb": round(peak_gb(dev), 3),
                       "finite": bool(torch.isfinite(g["albedo"]).all())})
    print(f"phase10 (d) cli invert --grad-accum {CLI_ACCUM_GROUPS}: {sec:.2f} s, step s "
          f"{acc_steps}, losses {inv['loss_first']:.6g} -> {inv['loss_last']:.6g}; per group "
          f"({step.sub_spp} spp each, spp_chunk {step.gcfg.spp_chunk}) {groups}")
    if not all(g["finite"] for g in groups):
        raise RuntimeError("phase10 (d): a group's gradient is not finite")
    out["grad_accum"] = {"s": sec, "step_s": acc_steps, "launches": got, "done": inv,
                         "groups": groups}

    # (e) The small invert demo: the fused kernels.
    recs, got, sec = cli_command(wrappers, ["invert", "--steps", str(CLI_DEMO_STEPS)],
                                 ("grad_fwd", "grad_bwd", "grad_fwd_soft", "grad_bwd_soft",
                                  "raygen"),
                                 forbid=("regen_fwd", "regen_fwd_soft"))
    inv = records_of(recs, "invert_done")[0]
    print(f"phase10 (e) cli invert demo, {CLI_DEMO_STEPS} steps: {sec:.2f} s, {json.dumps(inv)}; "
          f"launches {got}")
    if not all(map(math.isfinite, (inv["loss_first"], inv["loss_last"]))):
        raise RuntimeError("phase10 (e): the demo's losses are not finite")
    out["demo"] = {"s": sec, "launches": got, "done": inv}

    # (f) fit(balance=True) against the unbalanced fit: phase 6's hard fit,
    # of the smooth leaves (albedo, sky): a leaf whose gradient is near zero
    # (fuzz, ior) can take Adam steps of opposite sign from one run to the
    # next, as the bucket's atomics order its sums, and part two runs
    # further.  The kernels run the same work for any set of leaves.
    scene, cam, cfg = tpt.PRESETS["cover"].build(0, device=dev)
    key = tpt.make_key(0)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 1000))
    start = scene.replace(albedo=scene.albedo * ALBEDO_START,
                          sky_lo=scene.sky_lo * SKY_START, sky_hi=scene.sky_hi * SKY_START)
    fit_kw = dict(lr=FIT_LR, softness=0.0, leaves=("albedo", "sky_lo", "sky_hi"), device=dev)
    runs = []
    for balance in (False, True, True, False):
        sync(dev)
        t0 = time.perf_counter()
        _, losses = tpt.fit(start, target, cam, cfg, key, steps=BALANCE_STEPS, balance=balance,
                            **fit_kw)
        sync(dev)
        runs.append((balance, (time.perf_counter() - t0) / BALANCE_STEPS, losses))
    off = [s for b, s, _ in runs if not b]
    on = [s for b, s, _ in runs if b]
    # Rounds: (off, on) first and (on, off) second, each compared in its turn.
    wins = [on[0] < off[0] * (1 - BALANCE_MIN_GAIN), on[1] < off[1] * (1 - BALANCE_MIN_GAIN)]
    decision = "on" if all(wins) else "off"
    losses_off, losses_on = runs[0][2], runs[1][2]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_on, losses_off))
    print(f"phase10 (f) fit balance, {BALANCE_STEPS} steps each (off, on, on, off): s per step "
          f"{[round(s, 4) for _, s, _ in runs]}; balanced faster by "
          f"{[round(1 - a / b, 4) for a, b in zip(on, off)]}; losses rel diff {rel:.2e}; "
          f"measured decision for CUDA: {decision} (needs >= {BALANCE_MIN_GAIN:.0%} in both rounds)")
    if rel > 1e-4:
        raise RuntimeError("phase10 (f): the balanced fit's losses differ from the unbalanced")
    out["balance"] = {"s_per_step": [[b, s] for b, s, _ in runs], "loss_rel": rel,
                      "decision": decision}

    # (g) A fit snapshot's round trip on the card, and a resumed fit.
    snap, again = os.path.join(d, "fit.npz"), os.path.join(d, "again.npz")
    whole = [tpt.fit(start, target, cam, cfg, key, steps=2 * SNAPSHOT_STEPS, **fit_kw)[1]
             for _ in range(2)]
    fitted, head = tpt.fit(start, target, cam, cfg, key, steps=SNAPSHOT_STEPS, snapshot_path=snap,
                           snapshot_every=SNAPSHOT_STEPS, **fit_kw)
    params, opt = inverse.init(start, FIT_LR, fit_kw["leaves"])
    restored = inverse._load_fit_state(snap, params, opt) == (SNAPSHOT_STEPS, head)
    leaves_equal = all(torch.equal(v, getattr(fitted, k)) for k, v in params.items())
    inverse._save_fit_state(again, params, opt, SNAPSHOT_STEPS, head)
    with np.load(snap) as z1, np.load(again) as z2:
        files_equal = z1.files == z2.files and all(
            z1[k].dtype == z2[k].dtype and np.array_equal(z1[k], z2[k]) for k in z1.files)
    _, resumed = tpt.fit(start, target, cam, cfg, key, steps=2 * SNAPSHOT_STEPS,
                         snapshot_path=snap, snapshot_every=SNAPSHOT_STEPS, **fit_kw)

    def rel_diff(xs, ys):
        return max(abs(a - b) / abs(b) for a, b in zip(xs, ys))

    rel, spread = rel_diff(resumed, whole[0]), rel_diff(whole[1], whole[0])
    print(f"phase10 (g) fit snapshot on the card: restored {restored}, leaves bit-exact "
          f"{leaves_equal}, rewritten file bit-exact {files_equal}; resumed losses {resumed} "
          f"against uninterrupted {whole[0]}: rel diff {rel:.2e} (tolerance {SNAPSHOT_RTOL}; "
          f"two uninterrupted fits {spread:.2e})")
    if not (restored and leaves_equal and files_equal and resumed[:SNAPSHOT_STEPS] == head
            and rel <= SNAPSHOT_RTOL):
        raise RuntimeError("phase10 (g): the fit snapshot's round trip or resume failed")
    out["fit_snapshot"] = {"round_trip_bit_exact": True, "resumed_loss_rel": rel,
                           "uninterrupted_spread": spread}
    tmp.cleanup()
    return out


# Phase 11, the sharded path (parallel/ on torch.distributed): two ranks on
# the one card over gloo (NCCL refuses two ranks on one device), each job
# joined within SHARD_TIMEOUT seconds.  (a) render_sharded of the
# cover_multihost preset (1200x800, 2000 spp, depth 10) on a 2x1 and a 1x2
# mesh; (b) loss_and_grad_sharded on the cover preset at SHARD_GRAD_SPP spp,
# hard and soft; (c) a 2x1 render snapshotted after SHARD_HALF spp, loaded
# and finished; (d) SHARD_FIT_STEPS steps of fit_sharded.
SHARD_RANKS, SHARD_TIMEOUT = 2, 120.0
SHARD_MESHES = ((2, 1), (1, 2))
SHARD_HALF, SHARD_GRAD_SPP, SHARD_FIT_STEPS = 1000, 100, 2
# A samples split adds per-rank partial sums, each pixel's 2000 samples in
# another association: a float32 sum of n non-negative terms in any order
# is within (n - 1) 2^-24 of their sum relative, so two orders differ by
# at most 2 (n - 1) 2^-24 of the mean (SHARD_SUM_ROUNDINGS of them are
# held; the max difference is reported beside the 1e-5 that
# tests/test_sharding.py:47 holds at 8 spp); the sharded loss within 1e-6 relative of the single
# process's, the smooth leaves' gradients within rtol 1e-4 (atol 1e-6 of the
# leaf's largest entry), the geometry leaves' at cosine >= 0.999 (the same
# winners per ray, the sums in another order).
SHARD_SUM_ROUNDINGS, SHARD_LOSS_RTOL = 2, 1e-6
SHARD_SMOOTH_RTOL, SHARD_GEOM_COS = 1e-4, 0.999
SHARD_SMOOTH = ("albedo", "sky_lo", "sky_hi", "plane")
SHARD_GEOMETRY = ("centers", "radii")


def shard_target(cfg, dev):
    """The target of phase 11 (b): a constant linear image."""
    return torch.full((cfg.height, cfg.width, 3), 0.25, device=dev)


def shard_rank(rank, world, out):
    """One rank of phase 11 (cuda:0, shared with its peer): a warm-up at a
    small shape, then -- once the parent's references are done (the file
    ``out``/references_done) -- (a)-(d), each part with every launch count
    set to 0 just before it and read just after.  Writes its readings to
    ``out``/rank{rank}.json and rank 0's tensors to ``out``/rank0.pt."""
    import torch.distributed as dist

    import simplepathtracer_tpu_torch as tpt
    from simplepathtracer_tpu_torch import checkpoint, parallel
    from simplepathtracer_tpu_torch.inverse import fit_sharded
    from simplepathtracer_tpu_torch.ops.cuda_build import load_library

    dev = torch.device("cuda")
    load_library()  # the parent's build, from its cache
    wrappers = grad_wrappers()
    res = {"parts": {}}
    tensors = {}

    def part(label, fn, want):
        """Run ``fn`` with the counts at 0; its time (both ranks started and
        ended together), this rank's peak memory and launches.  The kernels
        in ``want`` must have launched and no plain version run."""
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        dist.barrier()
        got, calls = route_counts(wrappers)
        res["parts"][label] = {"s": time.perf_counter() - t0, "launches": got,
                               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        missing = [k for k in want if not got.get(k)]
        if missing or calls:
            raise RuntimeError(f"phase11 {label}: rank {rank} did not run through the kernels "
                               f"(launches {got}, plain calls {calls}, missing {missing})")
        return r

    scene, cam, cfg = tpt.PRESETS["cover_multihost"].build(0, device=dev)
    key = tpt.make_key(0)
    meshes = {f"{t}x{s}": parallel.make_mesh(t, s) for t, s in SHARD_MESHES}
    # Warm-up at 64x32 (each kernel's first launch in this process, Adam's
    # first step), timed apart.
    # The first gradient and the first optimizer step of a process import
    # modules for seconds (torch.optim imports torch._dynamo).
    small = tpt.PRESETS["cover"].config.replace(width=64, height=32, spp=4)
    res["warm"] = {}
    for name, fn in (
            ("render", lambda: parallel.render_sharded(scene, cam, small, key, meshes["1x2"])),
            ("grad", lambda: parallel.loss_and_grad_sharded(scene, shard_target(small, dev), cam,
                                                            small, key, meshes["1x2"])),
            ("fit_step", lambda: fit_sharded(scene, shard_target(small, dev), cam, small, key,
                                             meshes["1x2"], steps=1, leaves=("albedo",),
                                             device=dev))):
        before, t0 = set(sys.modules), time.perf_counter()
        fn()
        torch.cuda.synchronize()
        new = sorted({m.split(".")[0] for m in set(sys.modules) - before})
        res["warm"][name] = {"s": time.perf_counter() - t0, "new_modules": len(set(sys.modules) - before),
                             "new_top_level": new[:12]}
    go = os.path.join(out, "references_done")
    deadline = time.monotonic() + SHARD_TIMEOUT
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("phase11: the parent's references did not end")
        time.sleep(0.02)
    # (a) The sharded render on each mesh: the image through render_sharded
    # on 2x1; on 1x2 the sums render_sharded gathers, the image formed from
    # them as it forms it.
    tensors["a_2x1"] = part("a_render_2x1", lambda: parallel.render_sharded(
        scene, cam, cfg, key, meshes["2x1"]), ["persistent_render"])
    acc12 = part("a_render_1x2", lambda: parallel.gather_tiles(parallel.render_accum_sharded(
        scene, cam, cfg, key, meshes["1x2"]), cfg, meshes["1x2"]), ["persistent_render"])
    tensors["a_1x2_linear"] = acc12 / float(cfg.spp)
    tensors["a_1x2"] = gamma_image(acc12, cfg.spp).reshape(cfg.height, cfg.width, 3)
    # (c) Snapshot after SHARD_HALF spp on 2x1, load, finish.
    mesh = meshes["2x1"]
    prefix = os.path.join(out, "shard_snap")

    def resume():
        acc = parallel.render_accum_sharded(scene, cam, cfg, key, mesh, 0, SHARD_HALF)
        checkpoint.save_sharded(prefix, acc, SHARD_HALF, key, scene, cfg, mesh, cam)
        acc_l, done, key_l, scene_l, cfg_l, cam_l = checkpoint.load_sharded(prefix, mesh)
        if done != SHARD_HALF or cfg_l != cfg or not torch.equal(acc_l, acc):
            raise RuntimeError("phase11 (c): the sharded snapshot did not round-trip")
        more = parallel.render_accum_sharded(scene_l, cam_l, cfg_l, key_l, mesh, done,
                                             cfg.spp - done)
        return parallel.gather_tiles(acc_l + more, cfg, mesh)

    acc_c = part("c_snapshot_resume_2x1", resume, ["persistent_render"])
    tensors["c_2x1_linear"] = acc_c / float(cfg.spp)
    tensors["c_2x1"] = gamma_image(acc_c, cfg.spp).reshape(cfg.height, cfg.width, 3)
    # (b) The sharded gradient, hard then soft, on each mesh.
    gcfg = tpt.PRESETS["cover"].config.replace(spp=SHARD_GRAD_SPP)
    target = shard_target(gcfg, dev)
    regen = ["regen_fwd", "regen_refwd", "regen_bwd", "bucket"]
    for soft in (0.0, DEFAULT_SOFTNESS):
        c = gcfg.replace(silhouette_softness=soft)
        sfx = "" if soft == 0.0 else "_soft"
        for tag, mesh in meshes.items():
            loss, grads = part(f"b_grad{sfx}_{tag}",
                               lambda: parallel.loss_and_grad_sharded(scene, target, cam, c, key,
                                                                      mesh),
                               [k + sfx for k in regen[:3]] + ["bucket"])
            tensors[f"b{sfx}_{tag}"] = {"loss": loss, **grads}
    # (d) fit_sharded from dimmed albedo and sky on 1x2, hard.
    mesh = meshes["1x2"]
    with torch.no_grad():
        lin = parallel.gather_tiles(parallel.render_accum_sharded(
            scene, cam, gcfg.replace(use_pallas=True), tpt.fold_in(key, 999), mesh), gcfg, mesh)
    fit_target = (lin / gcfg.spp).reshape(gcfg.height, gcfg.width, 3)
    start = scene.replace(albedo=scene.albedo * ALBEDO_START, sky_lo=scene.sky_lo * SKY_START,
                          sky_hi=scene.sky_hi * SKY_START)
    stamps = []

    def stamp(*_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    fitted, losses = part("d_fit_sharded_1x2", lambda: (stamp(), fit_sharded(
        start, fit_target, cam, gcfg, key, mesh, steps=SHARD_FIT_STEPS, lr=FIT_LR,
        leaves=("albedo", "sky_lo", "sky_hi"), callback=stamp, device=dev))[1], regen)
    res["fit"] = {"losses": losses, "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
                  "albedo_err": [(start.albedo - scene.albedo).abs().mean().item(),
                                 (fitted.albedo - scene.albedo).abs().mean().item()]}
    tensors["d_albedo"] = fitted.albedo
    # Every rank must hold the same results: checksums beside rank 0's tensors.
    res["checksums"] = {k: float(sum(x.double().sum().item() for x in
                                     (v.values() if isinstance(v, dict) else [v])))
                        for k, v in tensors.items()}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    if rank == 0:
        torch.save({k: ({n: x.cpu() for n, x in v.items()} if isinstance(v, dict) else v.cpu())
                    for k, v in tensors.items()}, os.path.join(out, "rank0.pt"))


def cosine(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return (a @ b / (a.norm() * b.norm() + 1e-300)).item()


def phase11_sharded(tpt, dev):
    """Phase 11: the two-rank job (``shard_rank``), started first; the
    single process's references meanwhile; the comparisons.  Returns the
    readings."""
    from simplepathtracer_tpu_torch import parallel

    # The job starts first: its processes start, import and warm up while
    # this process renders the references; they wait for them before
    # their timed parts.
    tmp = tempfile.TemporaryDirectory(prefix="spt_shard_")
    job = {}

    def run_job():
        t_job = time.perf_counter()
        try:
            parallel.spawn_local(shard_rank, SHARD_RANKS, (tmp.name,),
                                 init_method=f"file://{os.path.join(tmp.name, 'store')}",
                                 backend="gloo", timeout=SHARD_TIMEOUT)
        except BaseException as e:  # raised below, in this thread
            job["error"] = e
        job["s"] = time.perf_counter() - t_job

    thread = threading.Thread(target=run_job)
    thread.start()
    preset = tpt.PRESETS["cover_multihost"]
    scene, cam, cfg = preset.build(0, device=dev)
    key = tpt.make_key(0)
    t0 = time.perf_counter()
    # render()'s image and the sums it forms it from.
    one = tpt.accumulate(tpt.init_state(cfg, key, device=dev), scene, cam, cfg, cfg.spp)
    ref, ref_linear = one.image(cfg.gamma), one.accum / float(cfg.spp)
    st = tpt.accumulate(tpt.init_state(cfg, key, device=dev), scene, cam, cfg, SHARD_HALF)
    ref_two = tpt.accumulate(st, scene, cam, cfg, cfg.spp - SHARD_HALF).image(cfg.gamma)
    gcfg = tpt.PRESETS["cover"].config.replace(spp=SHARD_GRAD_SPP)
    target = shard_target(gcfg, dev)
    ref_grads = {}
    for soft in (0.0, DEFAULT_SOFTNESS):
        c = gcfg.replace(silhouette_softness=soft)
        params, _ = tpt.split_params(scene)
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = tpt.pixel_loss(leaves, scene, target, cam, c, key, device=dev)
        g = torch.autograd.grad(loss, list(leaves.values()))
        ref_grads["" if soft == 0.0 else "_soft"] = {"loss": loss.detach(), **dict(zip(leaves, g))}
    sync(dev)
    ref_s = time.perf_counter() - t0
    del st
    torch.cuda.empty_cache()
    open(os.path.join(tmp.name, "references_done"), "w").close()
    print(f"phase11 single-process references ({cfg.width}x{cfg.height}x{cfg.spp}spp render, "
          f"the same in two chunks of {SHARD_HALF}, pixel_loss gradients at {SHARD_GRAD_SPP} spp "
          f"hard and soft {DEFAULT_SOFTNESS}): {ref_s:.2f} s")

    thread.join()
    if "error" in job:
        raise RuntimeError("phase11: the sharded job failed") from job["error"]
    job_s = job["s"]
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(tmp.name, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    got = torch.load(os.path.join(tmp.name, "rank0.pt"))
    tmp.cleanup()
    if any(r["checksums"] != ranks[0]["checksums"] for r in ranks[1:]):
        raise RuntimeError("phase11: the ranks do not hold the same results")

    out = {"job_s": job_s, "reference_s": ref_s, "ranks": SHARD_RANKS, "backend": "gloo",
           "warm_per_rank": [r["warm"] for r in ranks],
           "parts": {k: {"s": ranks[0]["parts"][k]["s"],
                         "peak_gb_per_rank": [r["parts"][k]["peak_gb"] for r in ranks],
                         "launches_per_rank": [r["parts"][k]["launches"] for r in ranks]}
                     for k in ranks[0]["parts"]},
           "fit": ranks[0]["fit"]}
    ref_c, ref_lin = ref.cpu(), ref_linear.cpu().reshape(-1, 3)
    tol = SHARD_SUM_ROUNDINGS * (cfg.spp - 1) * 2.0 ** -24 * ref_lin

    def linear(x):
        """Max |d| of the mean radiance, and its largest share of ``tol``."""
        d = (x - ref_lin).abs()
        return {"max_abs": d.max().item(),
                "max_over_tol": (d / tol.clamp_min(1e-30)).max().item()}

    # (a) 2x1 bit for bit; 1x2 to the samples bound on the mean radiance.
    d21 = (got["a_2x1"] - ref_c).abs().max().item()
    d12 = linear(got["a_1x2_linear"])
    # (c) bit for bit the single process's two chunks; within the bound of
    # (a)'s one pass.
    dc = (got["c_2x1"] - ref_two.cpu()).abs().max().item()
    dca = linear(got["c_2x1_linear"])
    out["render"] = {"max_abs_2x1": d21, "linear_1x2": d12,
                     "max_abs_gamma_1x2": (got["a_1x2"] - ref_c).abs().max().item(),
                     "resume_vs_two_chunks": dc, "linear_resume_vs_one_pass": dca,
                     "max_abs_gamma_resume_vs_one_pass": (got["c_2x1"] - ref_c).abs().max().item()}
    ok = (d21 == 0.0 and d12["max_over_tol"] <= 1.0 and dc == 0.0
          and dca["max_over_tol"] <= 1.0)
    # (b) against the single process's pixel_loss.
    out["grad"] = {}
    for sfx, want in ref_grads.items():
        for t, s_ in SHARD_MESHES:
            tag = f"{t}x{s_}"
            g = got[f"b{sfx}_{tag}"]
            rel = abs(g["loss"].item() - want["loss"].item()) / abs(want["loss"].item())
            row = {"loss_rel": rel}
            good = rel <= SHARD_LOSS_RTOL
            for k, w in want.items():
                if k == "loss":
                    continue
                w = w.cpu()
                if k in SHARD_SMOOTH:
                    err = ((g[k] - w).abs() - SHARD_SMOOTH_RTOL * w.abs()).max().item()
                    row[k] = {"max_abs": (g[k] - w).abs().max().item(),
                              "max_rel": ((g[k] - w).abs() / w.abs().clamp_min(1e-30)).max().item()}
                    good = good and err <= 1e-6 * w.abs().max().item()
                else:
                    row[k] = {"cosine": cosine(g[k], w)}
                    if k in SHARD_GEOMETRY:
                        good = good and row[k]["cosine"] >= SHARD_GEOM_COS
            out["grad"][f"{tag}{sfx}"] = row
            ok = ok and good
    losses = out["fit"]["losses"]
    ok = ok and len(losses) == SHARD_FIT_STEPS and all(map(math.isfinite, losses))
    out["ok"] = ok
    print("phase11 sharded (two ranks share one card over gloo: these times are not a "
          "multi-GPU scaling figure): " + json.dumps(out))
    if not ok:
        raise RuntimeError("phase11: the sharded path disagrees with the single process")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the full cover frame with and without lane balancing")
    ap.add_argument("--camera-adfd", action="store_true",
                    help="phase 8c: also the cover camera gradient against finite differences "
                         "coordinate by coordinate, on the fit's first key and on make_key(5)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    import simplepathtracer_tpu_torch as tpt
    from simplepathtracer_tpu_torch.ops import persistent
    from simplepathtracer_tpu_torch.ops.cuda_build import load_library
    from simplepathtracer_tpu_torch.render import _persistent_args

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_s, lap = {}, [t_start]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = round(now - lap[0], 2)
        lap[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # torch.optim's first step imports torch._dynamo (seconds of Python):
    # import it while nvcc builds the kernels.
    importer = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
    importer.start()
    t0 = time.perf_counter()
    lib = load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    importer.join()
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---") or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    for v, vname in enumerate(("hard", "soft", "soft_plane")):
        for mname, entry in (("idx", f"regen_idx_kernelILi{v}EE"),
                             ("full", f"regen_kernelILi0ELi{v}EE"),
                             ("re-forward", f"regen_kernelILi2ELi{v}EE")):
            print(f"regen forward {vname} {mname}: {ptxas_usage(lib.log, entry)}")
    for v, vname in enumerate(("hard", "soft")):
        print(f"fused backward {vname}: {ptxas_usage(lib.log, f'grad_bwd_kernelILi{v}EE')}")
    for v, vname in enumerate(("hard", "soft", "soft_plane")):
        print(f"regen backward {vname}: {ptxas_usage(lib.log, f'regen_bwd_kernelILi{v}EE')}")
    for v, vname in enumerate(("hard", "soft", "soft_plane")):
        for mname, entry in (("idx", f"regen_idx_lit_kernelILi{v}EE"),
                             ("full", f"regen_full_lit_kernelILi{v}EE"),
                             ("backward", f"regen_bwd_lit_kernelILi{v}EE")):
            print(f"regen emissive {vname} {mname}: {ptxas_usage(lib.log, entry)}")
    print(f"closest_hit_attrs: {ptxas_usage(lib.log, 'closest_hit_attrs_kernel')}")
    print(f"bounce_step: {ptxas_usage(lib.log, 'bounce_step_kernel')}")
    for k in BUCKET_NAMES:
        print(f"bucket_kernel<{k}>: {ptxas_usage(lib.log, f'bucket_kernelILi{k}EE')}")
    print(f"closest_hit_kernel: {ptxas_usage(lib.log, 'closest_hit_kernel')}")

    kernel = persistent.render_block_persistent
    plain = persistent.render_block_persistent_reference

    phase_done("build")

    # ---- phase 1: kernel vs plain version --------------------------------
    trio_cam = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)
    cases = [
        # name, scene, camera, w, h, spp, depth, rr, (mean bound, outlier bound)
        ("cover", tpt.compact_scene(tpt.cover_scene(0, device=dev)),
         tpt.PRESETS["cover"].camera_fn(dev), 64, 32, 4, 10, 0, (2.3e-4, 0.021)),
        ("three_sphere_plane", tpt.with_ground_plane(tpt.three_sphere_scene(device=dev)),
         tpt.make_camera(**trio_cam, device=dev), 48, 24, 8, 10, 2, (1e-4, 5e-3)),
        ("reference_37x13", tpt.reference_scene(device=dev),
         tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev),
         37, 13, 4, 10, 0, (1e-4, 5e-3)),
    ]
    max_abs_err = 0.0
    compare_args = None
    for name, scene, cam, w, h, spp, depth, rr, (mean_bound, out_bound) in cases:
        cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                               rr_start_depth=rr, use_pallas=True)
        tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
        pix = torch.arange(w * h, device=dev)
        call = (pix, tables, sky6, cam19, tpt.make_key(1), 0, spp, depth, w, h)
        kw = dict(rr_start_depth=rr, return_counts=True, plane7=scene.plane)
        a, ca = kernel(*call, **kw)
        torch.cuda.synchronize()
        b, cb = plain(*call, **kw)
        d = (gamma_image(a, spp) - gamma_image(b, spp)).abs()
        mean, out = d.mean().item(), (d > 1e-4).float().mean().item()
        flips = (ca != cb).float().mean().item()
        max_abs_err = max(max_abs_err, d.max().item())
        print(f"phase1 {name} {w}x{h} spp={spp} depth={depth} rr={rr} spheres={scene.num_spheres}: "
              f"mean|d|={mean:.3e} outliers={out:.4f} count_mismatch={flips:.4f} max|d|={d.max().item():.3e}")
        if not (torch.isfinite(a).all() and mean < mean_bound and out < out_bound and flips < out_bound):
            raise RuntimeError(f"phase1 {name}: kernel disagrees with its plain version")
        if name == "cover":
            compare_args = (call, kw, f"{w}x{h}x{spp}spp")

    phase_done("phase1")

    # ---- phase 2: balancing changes no pixel -----------------------------
    scene = tpt.reference_scene(device=dev)
    cam = tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev)
    base = dict(width=40, height=26, spp=8, max_depth=6, use_pallas=True)
    key = tpt.make_key(5)
    cfg_bal = tpt.RenderConfig(**base, balance_probe_spp=2)
    st = tpt.accumulate(tpt.init_state(cfg_bal, key, device=dev), scene, cam, cfg_bal, 8)
    cfg = tpt.RenderConfig(**base)
    st2 = tpt.accumulate(tpt.init_state(cfg, key, device=dev), scene, cam, cfg, 2)
    st2 = tpt.accumulate(st2, scene, cam, cfg, 6)
    if not torch.equal(st.accum, st2.accum):
        raise RuntimeError("phase2: balanced accumulate differs from the 2+6 schedule")
    print("phase2 balanced 40x26 8spp (probe 2): bit-identical to the 2+6 schedule")

    phase_done("phase2")

    # ---- phase 3: the main path at full width ----------------------------
    preset = tpt.PRESETS["cover"]
    scene, cam, cfg = preset.build(0, device=dev)
    key = tpt.make_key(0)
    warm = cfg.replace(width=64, height=32, spp=2)
    tpt.render(scene, cam, warm, key)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = tpt.render(scene, cam, cfg, key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    since = counts_since_reset()
    launches = since["launch.persistent"]
    plain_calls = since["plain.render_block_persistent_reference"]
    paths = cfg.num_pixels * cfg.spp
    print(f"phase3 cover {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth} "
          f"spheres={scene.num_spheres}: {seconds:.4f} s, {paths / seconds / 1e6:.2f} Mpaths/s, "
          f"kernel launches={launches}, plain calls={plain_calls}")
    if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all() or img.max() <= 0:
        raise RuntimeError("phase3: image is not finite or is all zero")
    if launches < 1 or plain_calls != 0:
        raise RuntimeError("phase3: the main path did not run through the kernel")
    img_mean = img.mean(dim=(0, 1)).tolist()
    print(f"phase3 image mean rgb {img_mean}")

    phase_done("phase3")

    # ---- phase 4: kernel vs plain version at the main path's shapes -------
    # The kernel renders the whole 1200x800 frame at 100 spp; the plain
    # version renders a random subset of its pixels with the same tables,
    # key and sample ids.  Each pixel's sum is independent of the others,
    # so the rows must agree bit for bit.
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    full_call = (pix, tables, sky6, cam19, key, 0, cfg.spp, cfg.max_depth, cfg.width, cfg.height)
    sums, counts = kernel(*full_call, return_counts=True)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    sub_call = (rows,) + full_call[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_sums, ref_counts = plain(*sub_call, return_counts=True)
    torch.cuda.synchronize()
    plain_main_ms = (time.perf_counter() - t0) * 1e3
    d_main = (sums[rows] - ref_sums).abs().max().item()
    count_rows = (counts[rows] != ref_counts).sum().item()
    max_abs_err = max(max_abs_err, d_main)
    print(f"phase4 cover {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth}, "
          f"{N_CHECK_PIXELS} random pixels: max|d| of sums={d_main:.3e}, "
          f"rows with unequal counts={count_rows}, plain {plain_main_ms:.1f} ms")
    if not (d_main == 0.0 and count_rows == 0):
        raise RuntimeError("phase4: kernel disagrees with its plain version at full width")

    # ---- measurements ----------------------------------------------------
    iters = counts.double().sum().item()
    ms = cuda_ms(lambda: kernel(*full_call), reps=3)
    # Dead slots (compact_scene's padding) need no test: count live spheres.
    live = ((scene.radii.abs() > 1e-3) & (scene.centers[:, 1] > -1e6)).sum().item()
    ops = iters * live * FLOPS_PER_SPHERE_TEST
    nbytes = cfg.num_pixels * (4 + 12) + scene.num_spheres * 11 * 4
    bound_ms = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    print(f"kernel cover full frame: {ms:.3f} ms, iterations {iters:.0f} "
          f"({iters / paths:.3f} per path), {live} live spheres, bound {bound_ms:.3f} ms (FP32 ops), "
          f"{bound_ms / ms:.3f} of bound")
    usage = ptxas_usage(lib.log, "persistent_kernelILb0EE")
    groups = persistent.sample_groups(cfg.spp)
    usage["grid_blocks"] = persistent.grid_blocks(cfg.num_pixels * groups, scene.num_spheres)
    usage["split_ms"] = persistent_split_ms(lambda: kernel(*full_call))
    print(f"persistent kernel: {usage.get('registers')} registers, {usage.get('spill_bytes')} B "
          f"spilled, {usage.get('stack_bytes')} B stack frame (nvcc -Xptxas -v); resident grid "
          f"{usage['grid_blocks']} blocks x 128 lanes ({usage['grid_blocks'] * 128} lanes fetch "
          f"the frame's {cfg.num_pixels} pixels x {groups} sample groups); profiled "
          f"persistent_kernel<false> / persistent_kernel_combine ms: {usage['split_ms']}")
    call, kw, shape = compare_args
    kw = dict(kw, return_counts=False)
    plain_ms = cuda_ms(lambda: plain(*call, **kw), reps=2)
    kernel_small_ms = cuda_ms(lambda: kernel(*call, **kw), reps=10)
    print(f"cover {shape}: plain {plain_ms:.3f} ms, kernel {kernel_small_ms:.3f} ms")

    if args.sweep:
        # Balanced schedule: 2 probe spp in image order, 98 in cost order
        # (the kernel fetches the costliest pixels first).
        cfg_bal = cfg.replace(balance_probe_spp=2)
        for name, c in (("unbalanced", cfg), ("balanced", cfg_bal), ("unbalanced", cfg),
                        ("balanced", cfg_bal)):
            t = cuda_ms(lambda: tpt.render(scene, cam, c, key), reps=1)
            print(f"sweep: render() {name} {t:.3f} ms")

    phase_done("phase4")

    # ---- phase 4e: the emissive build on smallpt's frame --------------------
    lit4e = phase4e_emissive(tpt, dev, lib)

    phase_done("phase4e")

    # ---- phase 5: gradient kernels vs plain versions, small shapes --------
    grad_errs, grad_plain_ms, grad_kernel_small_ms, grad_shapes = phase5_kernels(tpt, dev)

    phase_done("phase5")

    # ---- phase 6: the gradient path at full width -------------------------
    wrappers = grad_wrappers()
    main6 = phase6_main(tpt, dev, scene, cam, cfg, key, sums, counts, wrappers)
    for name, err in main6["full_width_errs"].items():
        grad_errs[name] = max(grad_errs[name], err)
    n_chunks = main6["n_chunks"]
    per_step = {k: v / FIT_STEPS for k, v in main6["launches"].items()}
    if not (set(per_step) == {"regen_fwd", "regen_refwd", "regen_bwd", "bucket"}
            and per_step["regen_fwd"] >= n_chunks and per_step["regen_refwd"] == n_chunks
            and per_step["regen_bwd"] == n_chunks and per_step["bucket"] == n_chunks
            and not any(main6["plain_calls"].values())):
        raise RuntimeError(f"phase6: the fit did not run through the kernels only "
                           f"(launches per step {per_step}, plain calls {main6['plain_calls']})")
    print("phase6 fit: " + json.dumps({
        "shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}",
        "spp_chunk": main6["chunk"], "chunks": n_chunks, "steps": FIT_STEPS,
        "s_per_step": main6["step_s"],
        "mpaths_per_s": cfg.num_pixels * cfg.spp / main6["step_s"] / 1e6,
        "peak_gb": main6["fit_peak_gb"], "grad_s": main6["grad_s"],
        "losses": main6["losses"], "launches_per_step": per_step,
    }))

    phase_done("phase6")

    # ---- phase 7: soft silhouettes on the main path ----------------------
    main7 = phase7_soft(tpt, dev, wrappers)
    for res in (main7, main7["plane_kernels"]):
        for name, err in res["full_width_errs"].items():
            grad_errs[name] = max(grad_errs[name], err)
    print("phase7 fit: " + json.dumps({
        "shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}",
        "softness": DEFAULT_SOFTNESS, "spp_chunk": main7["chunk"], "chunks": main7["n_chunks"],
        "steps": FIT_STEPS, "s_per_step": main7["step_s"],
        "mpaths_per_s": cfg.num_pixels * cfg.spp / main7["step_s"] / 1e6,
        "peak_gb": main7["fit_peak_gb"], "losses": main7["losses"],
        "center_x_err": main7["center_x_err"], "radius_err": main7["radius_err"],
        "launches_per_step": main7["per_step"], "plane_fit": main7["plane_fit"],
        "sil_fresnel_fit": main7["fresnel_fit"],
        "plane_launches": main7["plane_launches"], "adfd": main7["adfd"],
    }))

    phase_done("phase7")

    # ---- phase 7e: gradients of an emitter-lit scene on the main path -----
    main7e = phase7e_lit(tpt, dev, wrappers)
    print("phase7e fit: " + json.dumps({
        "shape": f"smallpt 1024x768x{LIT_SPP}spp", "softness": DEFAULT_SOFTNESS,
        "spp_chunk": main7e["chunk"], "chunks": main7e["n_chunks"], "steps": FIT_STEPS,
        "s_per_step": main7e["step_s"], "peak_gb": main7e["fit_peak_gb"],
        "losses": main7e["losses"], "light_emission": main7e["emission"],
        "launches_per_step": main7e["per_step"],
    }))

    phase_done("phase7e")

    # ---- phase 8: camera gradients through the fused kernels -------------
    fused_errs, fused_plain_ms, fused_small_ms, fused_shapes = phase8_kernels(tpt, dev)
    phase_done("phase8a")
    main8b = phase8_fused_route(tpt, dev, wrappers, lib)
    phase_done("phase8b")
    main8c = phase8_fit_camera(tpt, dev, wrappers, extra_adfd=args.camera_adfd)
    phase_done("phase8c")
    adfd8 = phase8_adfd(tpt, dev, wrappers)
    phase_done("phase8d")
    readme8 = phase8_readme_example(tpt, dev)
    phase_done("phase8e")
    jitter8 = phase8_camera_jitter(tpt, dev, lib)
    phase_done("phase8f")
    for res in (main8b, main8c):
        for name, err in res["errs"].items():
            fused_errs[name] = max(fused_errs[name], err)
    fused_errs["raygen"] = max(fused_errs["raygen"], main8b["raygen"]["max_abs_err"])
    print("phase8: " + json.dumps({
        "fused_route": {
            "shape": f"{cfg.width}x{cfg.height}x{FUSED_SPP}spp depth {cfg.max_depth}, one chunk",
            "s_per_step": main8b["step_s"],
            "mpaths_per_s": cfg.num_pixels * FUSED_SPP / main8b["step_s"] / 1e6,
            "peak_gb": main8b["peak_gb"], "launches": main8b["launches"], "steps": FUSED_STEPS,
            "loss_rel_vs_regen": main8b["loss_rel"], "bucket": main8b["bucket"],
            "live_rays_per_bounce": main8b["live"],
            "fwd_ms_per_bounce": main8b["fwd_ms_per_bounce"],
            "fwd_ns_per_live_ray_bounce": main8b["fwd_ns_per_live_ray_bounce"],
            "bwd_ms_per_bounce": main8b["bwd_ms_per_bounce"],
            "bwd_ns_per_live_ray_bounce": main8b["bwd_ns_per_live_ray_bounce"],
        },
        "fit_camera": {
            "shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}",
            "softness": DEFAULT_SOFTNESS, "spp_chunk": main8c["chunk"],
            "chunks": main8c["n_chunks"], "steps": FIT_STEPS, "s_per_step": main8c["step_s"],
            "mpaths_per_s": cfg.num_pixels * cfg.spp / main8c["step_s"] / 1e6,
            "peak_gb": main8c["peak_gb"], "losses": main8c["losses"],
            "camera_error": main8c["cam_err"], "launches_per_step": main8c["per_step"],
            "camera_adfd": main8c["camera_adfd"],
            "live_rays_per_bounce": main8c["live"],
            "fwd_ms_per_bounce": main8c["fwd_ms_per_bounce"],
            "fwd_ns_per_live_ray_bounce": main8c["fwd_ns_per_live_ray_bounce"],
            "bwd_ms_per_bounce": main8c["bwd_ms_per_bounce"],
            "bwd_ns_per_live_ray_bounce": main8c["bwd_ns_per_live_ray_bounce"],
        },
        "vfov_adfd": adfd8,
        "readme_fit_camera": readme8,
    }))

    # ---- phase 9: the explicit-ray forward and the use_pallas_hits route --
    exp_errs, exp_plain_ms, exp_small_ms, exp_shapes = phase9_kernels(tpt, dev)
    phase_done("phase9a")
    main9b = phase9_explicit_forward(tpt, dev, wrappers)
    phase_done("phase9b")
    main9c = phase9_hits_fit(tpt, dev, wrappers)
    phase_done("phase9c")
    main9d = phase9_closest_hit(tpt, dev, wrappers, lib)
    phase_done("phase9d")
    for name, res in (("bounce_step", main9b), ("closest_hit_attrs", main9c),
                      ("closest_hit", main9d)):
        exp_errs[name] = max(exp_errs[name], res["err"])
    paths9 = cfg.num_pixels * FUSED_SPP
    print("phase9: " + json.dumps({
        "explicit_forward": {
            "shape": f"{cfg.width}x{cfg.height}x{FUSED_SPP}spp depth {cfg.max_depth}",
            "s": main9b["s"], "mpaths_per_s": paths9 / main9b["s"] / 1e6,
            "ms_per_launch": main9b["ms"], "ms_per_bounce": main9b["ms_per_bounce"],
            "live_rays_per_bounce": main9b["live"],
            "live_groups_per_bounce": main9b["live_groups"],
            "vs_persistent": main9b["vs_persistent"],
        },
        "hits_fit": {
            "shape": f"{cfg.width}x{cfg.height}x{FUSED_SPP}spp depth {cfg.max_depth}",
            "spp_chunk": main9c["chunk"], "chunks": main9c["n_chunks"], "steps": FIT_STEPS,
            "s_per_step": main9c["step_s"], "mpaths_per_s": paths9 / main9c["step_s"] / 1e6,
            "peak_gb": main9c["peak_gb"], "losses": main9c["losses"],
            "launches_per_step": main9c["per_step"], "loss_rel_vs_fused": main9c["loss_rel"],
            "grad_l2_vs_fused": main9c["grad_l2"], "live_rays_per_bounce": main9c["live"],
            "attrs_ms_per_bounce": main9c["ms_per_bounce"],
            "attrs_table_per_call_ms_per_bounce": main9c["table_per_call_ms_per_bounce"],
            "bucket_ms_per_bounce": main9c["bucket_ms"],
            "kernel_share_of_step": main9c["kernel_share"],
        },
        "closest_hit": {"rays": main9d["n_rays"], "hit_share": main9d["hit_share"]},
    }))

    # ---- phase 10: the command line ---------------------------------------
    cli10 = phase10_cli(tpt, dev, wrappers, seconds)
    phase_done("phase10")

    # ---- phase 11: the sharded path ----------------------------------------
    sharded11 = phase11_sharded(tpt, dev)
    phase_done("phase11")

    # The bucket at every shape the main paths give it (one launch per chunk
    # of the hard, default and plane fits; the fused scene-leaf step's
    # launches summed; the hits route's launch per bounce) and its key
    # coherence at each chunk.
    plane_k, plane_fit = main7["plane_kernels"], main7["plane_fit"]
    bucket_shapes = {
        "bucket": {"hard_chunk": main6["ms"]["bucket"], "soft_chunk": main7["ms"]["bucket"],
                   "plane_chunk": plane_k["ms"]["bucket"],
                   "fused_step_sum": main8b["bucket"]["ms"],
                   "hits_per_bounce": main9c["bucket_ms"]},
        "bucket_blocker": {"soft_chunk": main7["ms"]["bucket_blocker"],
                           "plane_chunk": plane_k["ms"]["bucket_blocker"]},
    }
    print("bucket ms by shape: " + json.dumps(bucket_shapes))

    def bucket_extra(name):
        """The bucket rows' registers, times by shape and key coherence."""
        if name not in bucket_shapes:
            return {}
        k = 9 if name == "bucket" else N_BLK_PLANES
        coh = {shape: res["coherence"][name] for shape, res in
               (("hard_chunk", main6), ("soft_chunk", main7), ("plane_chunk", plane_k))
               if name in res["coherence"]}
        return {**ptxas_usage(lib.log, f"bucket_kernelILi{k}EE"),
                "ms_by_shape": bucket_shapes[name], "coherence": coh}

    report = {"kernels": [{
        "name": "persistent_render",
        "route": "cuda",
        "source": "simplepathtracer_tpu_torch/csrc/persistent.cu",
        "replaces": "simplepathtracer_tpu/ops/pallas_persistent.py:72",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": None,
        "ms_shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp",
        "plain_ms_shape": shape,
        "plain_ms_main_shape": plain_main_ms,
        "plain_ms_main_shape_pixels": N_CHECK_PIXELS,
        "kernel_ms_at_plain_shape": kernel_small_ms,
        **usage,
    }, lit4e]}
    def regen_fwd_extra(name, res, v):
        """The regen forward's registers (both recording modes), lane
        shares and full-residual time; the re-forward's registers and its
        dead entries' store-only passes; nothing for the other kernels."""
        if name.startswith("regen_refwd"):
            return {**ptxas_usage(lib.log, f"regen_kernelILi2ELi{v}EE"),
                    "dead_store": res["dead_store"]}
        if not name.startswith("regen_fwd"):
            return {}
        return {"ptxas_idx": ptxas_usage(lib.log, f"regen_idx_kernelILi{v}EE"),
                "ptxas_full": ptxas_usage(lib.log, f"regen_kernelILi0ELi{v}EE"),
                "lane_share": res["lane_share"], "full_ms": res["full_ms"]}

    def fresnel_extra(name, res):
        """The kernel's time with SIL_FRESNEL on beside its time with it
        off, where the row has one (the soft backwards)."""
        t = res.get("fresnel_ms", {}).get(name)
        return {"sil_fresnel_ms": t} if t else {}

    for name, source, replaces in GRAD_KERNELS:
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main6["launches"][name],
            "max_abs_err": grad_errs[name],
            "ms": main6["ms"][name],
            "plain_ms": grad_plain_ms[name],
            "bound_ms": main6["bound_ms"][name],
            "bound_by": main6["bound_by"][name],
            "library_ms": main6["library_ms"].get(name),
            "ms_shape": f"{cfg.width}x{cfg.height}x{main6['chunk']}spp",
            "plain_ms_shape": grad_shapes[name],
            "kernel_ms_at_plain_shape": grad_kernel_small_ms[name],
            "launches_over_fit_steps": FIT_STEPS,
            **regen_fwd_extra(name, main6, 0),
            **bucket_extra(name),
        })
    for name, source, replaces in SOFT_KERNELS:
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main7["launches"][name],
            "max_abs_err": grad_errs[name],
            "ms": main7["ms"][name],
            "plain_ms": grad_plain_ms[name],
            "bound_ms": main7["bound_ms"][name],
            "bound_by": main7["bound_by"][name],
            "library_ms": main7["library_ms"].get(name),
            "ms_shape": f"{cfg.width}x{cfg.height}x{main7['chunk']}spp soft {DEFAULT_SOFTNESS}",
            "plain_ms_shape": grad_shapes[name],
            "kernel_ms_at_plain_shape": grad_kernel_small_ms[name],
            "launches_over_fit_steps": FIT_STEPS,
            **regen_fwd_extra(name, main7, 1),
            **bucket_extra(name),
            **fresnel_extra(name, main7),
        })
    for name, source, replaces in SOFT_PLANE_KERNELS:
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main7["plane_launches"][name],
            "max_abs_err": grad_errs[name],
            "ms": plane_k["ms"][name],
            "plain_ms": grad_plain_ms[name],
            "bound_ms": plane_k["bound_ms"][name],
            "bound_by": plane_k["bound_by"][name],
            "library_ms": None,
            "ms_shape": f"three_sphere_plane {plane_fit['shape']} soft {DEFAULT_SOFTNESS}",
            "plain_ms_shape": grad_shapes[name],
            "kernel_ms_at_plain_shape": grad_kernel_small_ms[name],
            "launches_over_fit_steps": FIT_STEPS,
            "launches_over_fits": [f["spp_chunk"] for f in plane_fit["fits"]],
            **regen_fwd_extra(name, plane_k, 2),
            **fresnel_extra(name, plane_k),
        })
    lit_ptxas = {"regen_fwd_soft_emit": "regen_idx_lit_kernelILi1EE",
                 "regen_refwd_soft_emit": "regen_kernelILi2ELi1EE",
                 "regen_bwd_soft_emit": "regen_bwd_lit_kernelILi1EE",
                 "bucket_emit": "bucket_kernelILi12EE"}
    for name, source, replaces in LIT_KERNELS:
        extra = {"ptxas_full": ptxas_usage(lib.log, "regen_full_lit_kernelILi1EE"),
                 "lane_share": main7e["lane_share"], "full_ms": main7e["full_ms"]} \
            if name == "regen_fwd_soft_emit" else {}
        if name == "bucket_emit":
            extra = {"coherence": main7e["coherence"][name]}
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main7e["launches"][name],
            "max_abs_err": main7e["full_width_errs"][name],
            "ms": main7e["ms"][name],
            "plain_ms": main7e["plain_ms"].get(name),
            "bound_ms": main7e["bound_ms"][name],
            "bound_by": main7e["bound_by"][name],
            "library_ms": main7e["library_ms"].get(name),
            "ms_shape": f"smallpt 1024x768x{main7e['chunk']}spp soft {DEFAULT_SOFTNESS}",
            "plain_ms_shape": f"{N_CHECK_PIXELS} lanes x {main7e['chunk']}spp",
            "launches_over_fit_steps": FIT_STEPS,
            **ptxas_usage(lib.log, lit_ptxas[name]),
            **extra,
        })
    for name, source, replaces in FUSED_KERNELS:
        res = main8c if name.endswith("_soft") else main8b
        fwd = {}
        if name == "raygen":
            rg = main8b["raygen"]
            fwd = {k: rg[k] for k in ("ms_kernel_alone", "ms_int32_ids", "ms_scalar_path_alone",
                                      "bound_bytes_ms", "bound_ops_ms", "ops_per_ray",
                                      "sass_per_ray", "ptxas_scalar", "checks")}
            fwd.update(rg["ptxas"])
        for pre in ("grad_fwd", "grad_bwd"):
            if name.startswith(pre):
                fwd = dict(ptxas_usage(lib.log, f"{pre}_kernelILi{int(res is main8c)}EE"),
                           ms_per_bounce=res[pre[5:] + "_ms_per_bounce"],
                           ns_per_live_ray_bounce=res[pre[5:] + "_ns_per_live_ray_bounce"])
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": res["launches"][name],
            "max_abs_err": fused_errs[name],
            "ms": main8b["raygen"]["ms"] if name == "raygen" else res["ms"][name],
            "plain_ms": fused_plain_ms[name],
            "bound_ms": main8b["raygen"]["bound_ms"] if name == "raygen" else res["bound_ms"][name],
            "bound_by": main8b["raygen"]["bound_by"] if name == "raygen" else res["bound_by"][name],
            "library_ms": None,
            "ms_shape": (f"{cfg.width}x{cfg.height}x{res['n_rays'] // cfg.num_pixels}spp depth "
                         f"{cfg.max_depth}{' soft ' + str(DEFAULT_SOFTNESS) if res is main8c else ''}"
                         ", per launch"),
            "plain_ms_shape": fused_shapes[name] + ", per launch",
            "kernel_ms_at_plain_shape": fused_small_ms[name],
            "launches_over_steps": FUSED_STEPS if res is main8b else FIT_STEPS,
            **fwd,
            **fresnel_extra(name, res),
        })
    report["kernels"].append({
        "name": "camera_jitter",
        "route": "cuda",
        "source": _SRC + "camera_jitter.cu",
        "replaces": None,
        "launches": main8c["launches"].get("camera_jitter", 0),
        "max_abs_err": jitter8["max_abs_err"],
        "ms": jitter8["ms"],
        "plain_ms": jitter8["plain_ms"],
        "bound_ms": jitter8["bound_ms"],
        "bound_by": jitter8["bound_by"],
        "library_ms": None,
        "ms_shape": f"{cfg.width}x{cfg.height}x{jitter8['n_rays'] // cfg.num_pixels}spp, per launch",
        "plain_ms_shape": f"{cfg.width}x{cfg.height}x{jitter8['n_rays'] // cfg.num_pixels}spp",
        "launches_over_steps": FIT_STEPS,
        **{k: jitter8[k] for k in ("ms_kernel_alone", "bound_bytes_ms", "bound_ops_ms",
                                   "ops_per_ray", "checks")},
        **jitter8["ptxas"],
    })
    explicit = {"bounce_step": (main9b, f"{cfg.width}x{cfg.height}x{FUSED_SPP}spp depth "
                                        f"{cfg.max_depth}, per launch (render_pixels)"),
                "closest_hit_attrs": (main9c, f"{cfg.width}x{cfg.height}x{main9c['chunk']}spp "
                                              f"chunk of the hits fit, per launch"),
                "closest_hit": (main9d, f"{cfg.width}x{cfg.height} camera rays, one launch "
                                        f"through the wrapper (table built)")}
    for name, source, replaces in EXPLICIT_KERNELS:
        res, ms_shape = explicit[name]
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": (main9c["launches"] if name == "closest_hit_attrs"
                         else res["launches"]).get(name, 0),
            "max_abs_err": exp_errs[name],
            "ms": res["ms"],
            "plain_ms": exp_plain_ms[name],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": None,
            "ms_shape": ms_shape,
            "plain_ms_shape": exp_shapes[name],
            "kernel_ms_at_plain_shape": exp_small_ms[name],
        }
        if name == "closest_hit_attrs":
            row["launches_over_fit_steps"] = FIT_STEPS
        if name == "closest_hit":
            row.update(ptxas_usage(lib.log, "closest_hit_kernel"),
                       ms_kernel_alone=res["ms_kernel_alone"], grazing=res["grazing"])
        if name == "bounce_step":
            row.update(ptxas_usage(lib.log, "bounce_step_kernel"),
                       ms_per_bounce=res["ms_per_bounce"], live_rays_per_bounce=res["live"])
        report["kernels"].append(row)
    plane_steps = ", ".join(f"{f['s_per_step']:.4f} (spp_chunk {f['spp_chunk']})"
                            for f in main7["plane_fit"]["fits"])
    print(f"step times (s): hard fit {main6['step_s']:.4f}, default soft fit "
          f"{main7['step_s']:.4f}, fit_camera {main8c['step_s']:.4f}, fused scene-leaf "
          f"{main8b['step_s']:.4f}, hits fit {main9c['step_s']:.4f}, plane fit {plane_steps}")
    report["cli"] = cli10
    report["sharded"] = sharded11
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f} (from the card's first use; "
          f"per phase {phase_s}); wall {time.perf_counter() - _T_IMPORT:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
