"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
sm_90a, all started together, into an object file; one more ``nvcc`` links
the objects into a shared library with a plain C interface, loaded with
ctypes.  The build goes to the package's ``build/`` directory (ignored by
git), under a name keyed on a hash of the sources and flags, at first use:
never when a module is imported, so the CPU tests import every module
without a compiler.

The whole library is built with ``--fmad=false``: no product is contracted
into an FMA, so every kernel rounds as the PyTorch elementwise ops of its
plain version do (see ``csrc/persistent.cu``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17")
_COMPILE_FLAGS = _ARCH + (
    "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)
_LINK_FLAGS = _ARCH + ("-shared",)

P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C entry points of the library and their argument types.
_SIGNATURES = {
    # pixel_ids, n_pix, tab, n_spheres, consts, use_plane, k0, k1,
    # sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min, t_max,
    # rr_start_depth, next_pos, out_rad, out_cnt, stream
    "spt_persistent_render":
        [P, I, P, I, P, I, U, U, U, I, I, I, F, F, F, F, I, P, P, P, P],
    # n_pix, n_spheres, blocks (int out)
    "spt_persistent_grid": [I, I, P],
    # pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts, use_plane,
    # k0, k1, sample_offset, n_samples, max_depth, width, inv_w, inv_h,
    # t_min, t_max, rr_start_depth, n_iter, mode, softness, soft_tab,
    # idx_in, out_rad, out_cnt, resf, resi, packed, counters, stream
    "spt_regen_forward":
        [P, I, I, I, P, I, P, I, U, U, U, I, I, I, F, F, F, F, I, I, I, F, P,
         P, P, P, P, P, P, P, P],
    # pixel_ids, n_pix, n_lanes, n_banks, consts, use_plane, k0, k1,
    # sample_offset, n_iter, t_min, t_max, rr_start_depth, softness, resf,
    # resi, ct_rad, ct_planes, partials, stream
    "spt_regen_backward":
        [P, I, I, I, P, I, U, U, U, I, F, F, I, F, P, P, P, P, P, P],
    # cols, idx, n_rows, n_cols, n_buckets, out, stream
    "spt_bucket": [P, P, ctypes.c_longlong, I, I, P, P],
    # n, tab, n_spheres, consts, variant, soft_tab, k0, k1, bounce, t_min,
    # t_max, rr_start_depth, state, pix, samp, prev_in, next, rad, prev_out,
    # idx_out, bidx_out, stream
    "spt_grad_forward":
        [I, P, I, P, I, P, U, U, U, F, F, I, P, P, P, P, P, P, P, P, P, P],
    # n, tab, n_spheres, consts, variant, k0, k1, bounce, t_min, t_max,
    # rr_start_depth, state, idx, bidx, pix, samp, ct_in, ct_rad, ct_out,
    # ct_attr, sky_out, stream
    "spt_grad_backward":
        [I, P, I, P, I, U, U, U, F, F, I, P, P, P, P, P, P, P, P, P, P, P],
    # n, cam19, k0, k1, pix, samp, width, inv_w, inv_h, rays, stream
    "spt_raygen": [I, P, U, U, P, P, I, F, F, P, P],
    # n, tab, n_spheres, consts, use_plane, k0, k1, bounce, t_min, t_max,
    # rr_start_depth, state, pix, samp, next, stream
    "spt_bounce_step": [I, P, I, P, I, U, U, U, F, F, I, P, P, P, P, P],
    # n, spheres, n_spheres, origins, dirs, alive, t_min, t_max, idx, t,
    # stream
    "spt_closest_hit": [I, P, I, P, P, P, F, F, P, P, P],
    # n, tab, n_spheres, origins, dirs, alive, t_min, t_max, idx, attr, mat,
    # stream
    "spt_closest_hit_attrs": [I, P, I, P, P, P, F, F, P, P, P, P],
}


# Rays (or lanes) per launch of the per-ray kernels: they index one with a
# 32-bit int.
MAX_RAYS = 1 << 30


def on_cpu(t) -> bool:
    """Whether a wrapper takes its plain version for ``t``: True on the CPU,
    False on CUDA (the kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def stream(dev) -> int:
    """The handle of PyTorch's current CUDA stream on ``dev``: kernels
    launch there."""
    return torch.cuda.current_stream(dev).cuda_stream


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    log: str


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library.

    Returns a ``KernelLibrary`` with the ctypes handle, the .so path, the
    build seconds (0 when it was already built) and nvcc's output (kept
    beside the library, so a cached build returns it too).
    """
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(_COMPILE_FLAGS + _LINK_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so_path = _BUILD / f"spt_kernels_{h.hexdigest()[:16]}.so"
    log_path = so_path.with_suffix(".log")
    log, seconds = "", 0.0
    if so_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        nvcc = _nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
            cu = [s for s in sources if s.suffix == ".cu"]
            objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
            procs = [
                subprocess.Popen(
                    [nvcc, *_COMPILE_FLAGS, "-o", o, str(s)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for s, o in zip(cu, objs)
            ]
            failed = []
            for s, p in zip(cu, procs):
                out, _ = p.communicate()
                log += f"--- {s.name}\n{out}"
                if p.returncode != 0:
                    failed.append(s.name)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            so_tmp = os.path.join(tmp, "lib.so")
            proc = subprocess.run(
                [nvcc, *_LINK_FLAGS, "-o", so_tmp, *objs],
                capture_output=True, text=True,
            )
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(so_tmp, so_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=so_path, build_seconds=seconds, log=log)
