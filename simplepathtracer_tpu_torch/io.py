"""Image file I/O (counterpart of the JAX package's ``io.py``).

BMP files go through the native encoder (``native.py``) where it loads,
else the pure-Python one; PNG through zlib in Python, as in the JAX
package.  ``encoder`` names the encoder that writes a path."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from . import native


def to_u8(image_float) -> np.ndarray:
    """[H, W, 3] float in [0, 1] (already gamma-corrected) -> u8."""
    if isinstance(image_float, torch.Tensor):
        image_float = image_float.detach().cpu().numpy()
    img = np.asarray(image_float)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_bmp(path: str, u8_image: np.ndarray) -> None:
    """24-bit BMP: BGR, bottom-up, rows padded to 4 bytes."""
    img = np.asarray(u8_image)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("write_bmp takes an [H, W, 3] u8 image")
    if native.available():
        native.write_bmp(path, img)
        return
    h, w, _ = img.shape
    bgr = img[::-1, :, ::-1]
    row_size = (w * 3 + 3) & ~3
    pad = row_size - w * 3
    rows = bgr.tobytes() if pad == 0 else b"".join(
        bgr[y].tobytes() + b"\x00" * pad for y in range(h)
    )
    pixel_bytes = row_size * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 54 + pixel_bytes, 0, 0, 54,
        40, w, h, 1, 24, 0, pixel_bytes, 2835, 2835, 0, 0,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows)


def encode_png(image) -> bytes:
    """Minimal zlib PNG encoder -> PNG bytes (float [0, 1] or u8 image)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = to_u8(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_png takes an [H, W, 3] image")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
    )


def write_png(path: str, u8_image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(u8_image))


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit uncompressed BMP -> [H, W, 3] u8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path} is not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP is supported, got {bpp}")
    flip = h > 0
    h = abs(h)
    row_size = (w * 3 + 3) & ~3
    img = np.frombuffer(data, np.uint8, row_size * h, offset)
    img = img.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)
    img = img[:, :, ::-1]  # BGR -> RGB
    return img[::-1] if flip else img


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def save_image(path: str, image_float) -> str:
    """Quantize and save by extension (.png, else .bmp). Returns the path."""
    u8 = to_u8(image_float)
    if _is_png(path):
        write_png(path, u8)
    else:
        write_bmp(path, u8)
    return path


def encoder(path: str) -> str:
    """The encoder ``save_image`` writes ``path`` with: "native" (a BMP
    while the native library loads) or "python"."""
    return "native" if not _is_png(path) and native.available() else "python"


def default_filename(config, prefix: str = "output", ext: str = "bmp") -> str:
    """File name keyed by the config: ``output{spp}s{depth}b_{W}x{H}.bmp``."""
    return f"{prefix}{config.spp}s{config.max_depth}b_{config.width}x{config.height}.{ext}"
