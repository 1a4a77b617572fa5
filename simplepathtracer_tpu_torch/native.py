"""ctypes loader for the repo's native C++ image encoder
(``native/src/image_io.cpp``; counterpart of the JAX package's
``native.py``): ``write_bmp``, ``write_png`` and ``resolve_gamma_u8``.

The library is not in git, so the port builds it at first use with ``g++
-O3 -fPIC -shared ... -lz`` into its own build directory (the one
``ops/cuda_build.py`` builds the kernels into), under a name keyed on a hash
of the source and flags; it never writes into ``native/``.  Without a
compiler or zlib the build fails quietly, ``available()`` is False, and
``io`` uses its pure-Python encoders.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "src" / "image_io.cpp"
_BUILD = Path(__file__).resolve().parent / "build"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def _build() -> Path | None:
    """The built library's path (built now if missing), or None when the
    source or a compiler is missing or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None or not _SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SOURCE.read_bytes()).hexdigest()[:16]
    so_path = _BUILD / f"spt_native_{h}.so"
    if so_path.exists():
        return so_path
    _BUILD.mkdir(parents=True, exist_ok=True)
    # Built under a temporary name and renamed: processes building at once
    # each rename a whole library.
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SOURCE), "-lz"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


@functools.lru_cache(maxsize=None)
def _load():
    so_path = _build()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.write_bmp.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
    lib.write_bmp.restype = ctypes.c_int
    lib.write_png.argtypes = lib.write_bmp.argtypes
    lib.write_png.restype = ctypes.c_int
    lib.resolve_gamma_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), u8p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ]
    lib.resolve_gamma_u8.restype = None
    return lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def _u8_image(img) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("the native encoders take an [H, W, 3] u8 image")
    return img


def _write(fn, path: str, img) -> None:
    img = _u8_image(img)
    h, w, _ = img.shape
    rc = fn(os.fsencode(path), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h)
    if rc != 0:
        raise OSError(f"native {fn.__name__} failed ({rc}) for {path}")


def write_bmp(path: str, img) -> None:
    """24-bit BMP through the native encoder (byte-equal to ``io``'s)."""
    _write(_load().write_bmp, path, img)


def write_png(path: str, img) -> None:
    """8-bit RGB PNG through the native encoder (zlib level 6)."""
    _write(_load().write_png, path, img)


def resolve_gamma_u8(accum, count: int, gamma: float) -> np.ndarray:
    """Host-side resolve: [H, W, 3] f32 radiance sum -> gamma-corrected u8."""
    accum = np.ascontiguousarray(accum, np.float32)
    out = np.empty(accum.shape, np.uint8)
    _load().resolve_gamma_u8(
        accum.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        accum.size, 1.0 / max(count, 1), 1.0 / gamma,
    )
    return out
