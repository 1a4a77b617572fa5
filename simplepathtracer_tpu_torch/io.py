"""Image file output (counterpart of the JAX package's ``io.py``), with the
pure-Python encoders only: BMP by hand, PNG through zlib."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


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


def save_image(path: str, image_float) -> str:
    """Quantize and save by extension (.png, else .bmp). Returns the path."""
    u8 = to_u8(image_float)
    if os.path.splitext(path)[1].lower() == ".png":
        write_png(path, u8)
    else:
        write_bmp(path, u8)
    return path
