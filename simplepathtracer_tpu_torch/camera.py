"""Camera ray generation (counterpart of the JAX package's ``camera.py``):
orthonormal look-at basis, vertical field of view and thin-lens defocus,
pinhole when the aperture is 0."""

from __future__ import annotations

import math

import numpy as np
import torch

from .types import Camera


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _normalize(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-20)


def camera_basis(cam: Camera):
    """Right-handed orthonormal (u, v, w): w looks backwards (Shirley)."""
    w = _normalize(cam.origin - cam.lookat)
    u = _normalize(_cross(cam.vup, w))
    v = _cross(w, u)
    return u, v, w


def view_frame(cam: Camera, width: int, height: int):
    """(u, v, lower_left, horizontal, vertical) of the focal plane."""
    u, v, w = camera_basis(cam)
    aspect = width / height
    half_h = torch.tan(torch.deg2rad(cam.vfov_deg) * 0.5)
    half_w = aspect * half_h
    fd = cam.focus_dist
    lower_left = cam.origin - fd * (half_w * u + half_h * v + w)
    horizontal = 2.0 * half_w * fd * u
    vertical = 2.0 * half_h * fd * v
    return u, v, lower_left, horizontal, vertical


def generate_rays(cam: Camera, width, height, pixel_ids, jitter):
    """Primary rays for flattened pixel ids (y = 0 is the top row).

    jitter: [N, 4] uniforms — [:, :2] subpixel jitter, [:, 2:] lens disk.
    Returns (origins [N, 3], dirs [N, 3]) with unit dirs.
    """
    x = (pixel_ids % width).to(torch.float32)
    y = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    s = (x + jitter[:, 0]) / width
    t = 1.0 - (y + jitter[:, 1]) / height

    u, v, lower_left, horizontal, vertical = view_frame(cam, width, height)

    r = torch.sqrt(jitter[:, 2])
    theta = np.float32(2.0 * math.pi) * jitter[:, 3]
    lens = 0.5 * cam.aperture
    offset = (r * torch.cos(theta) * lens)[:, None] * u + (
        r * torch.sin(theta) * lens
    )[:, None] * v

    origins = cam.origin + offset
    dirs = _normalize(
        lower_left + s[:, None] * horizontal + t[:, None] * vertical - origins
    )
    return origins, dirs
