"""The thin-lens camera (Shirley's look-at camera with defocus).

Two formulations of the same rays, each as the route it is compared with
computes them, so that the two sides differ by rounding only:

* ``camera_ray`` from the f32[19] block of ``camera_constants`` (origin,
  lower-left corner, horizontal and vertical spans, u, v, lens radius): the
  forward render's and the scene gradient's rays, the camera held fixed;
* ``generate_rays``, differentiable in the camera's leaves: the camera
  gradient's rays.

Jitter and lens uniforms come from slots 124 and 125.  y = 0 is the top row.
"""

from __future__ import annotations

import math

import torch

from .rng import uniforms

_TWO_PI = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def make_camera(spec: dict, device, dtype=torch.float32) -> dict:
    """{origin, lookat, vup, vfov_deg, aperture, focus_dist} tensors from a
    configuration's ``camera`` block."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).to(dtype)

    cam = {k: t(spec[k]) for k in ("origin", "lookat", "vup", "vfov_deg", "aperture")}
    fd = spec.get("focus_dist")
    cam["focus_dist"] = (torch.linalg.norm(cam["lookat"] - cam["origin"]) if fd is None
                         else t(fd))
    return cam


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _normalize(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-20)


def view_frame(cam: dict, width: int, height: int):
    """(u, v, lower_left, horizontal, vertical) of the focal plane."""
    w = _normalize(cam["origin"] - cam["lookat"])
    u = _normalize(_cross(cam["vup"], w))
    v = _cross(w, u)
    half_h = torch.tan(torch.deg2rad(cam["vfov_deg"]) * 0.5)
    half_w = (width / height) * half_h
    fd = cam["focus_dist"]
    lower_left = cam["origin"] - fd * (half_w * u + half_h * v + w)
    return u, v, lower_left, 2.0 * half_w * fd * u, 2.0 * half_h * fd * v


def camera_constants(cam: dict, width: int, height: int) -> torch.Tensor:
    """f32[19]: origin 0:3, lower_left 3:6, horizontal 6:9, vertical 9:12,
    u 12:15, v 15:18, lens radius 18."""
    u, v, ll, hor, ver = view_frame(cam, width, height)
    lens = (0.5 * cam["aperture"]).reshape(1)
    return torch.cat([cam["origin"], ll, hor, ver, u, v, lens])


def camera_ray(cam19, key, pix, samp, width, height, dtype=torch.float32):
    """Rays (ox, oy, oz, dx, dy, dz) for int64 pixel and sample ids from the
    f32[19] block, values only."""
    c = cam19.tolist()
    xf = (pix % width).to(dtype)
    yf = torch.div(pix, width, rounding_mode="floor").to(dtype)
    jx, jy = uniforms(key, pix, samp, 124, dtype)
    lu, lv = uniforms(key, pix, samp, 125, dtype)
    inv_w = float(torch.tensor(1.0 / width, dtype=torch.float32))
    inv_h = float(torch.tensor(1.0 / height, dtype=torch.float32))
    s01 = (xf + jx) * inv_w
    t01 = 1.0 - (yf + jy) * inv_h
    lr = torch.sqrt(lu) * c[18]
    th = _TWO_PI * lv
    ou, ov = lr * torch.cos(th), lr * torch.sin(th)
    ox = c[0] + ou * c[12] + ov * c[15]
    oy = c[1] + ou * c[13] + ov * c[16]
    oz = c[2] + ou * c[14] + ov * c[17]
    dx = c[3] + s01 * c[6] + t01 * c[9] - ox
    dy = c[4] + s01 * c[7] + t01 * c[10] - oy
    dz = c[5] + s01 * c[8] + t01 * c[11] - oz
    ninv = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
    return ox, oy, oz, dx * ninv, dy * ninv, dz * ninv


def generate_rays(cam: dict, width, height, key, pix, samp, dtype=torch.float32):
    """Differentiable rays (origins [N, 3], unit dirs [N, 3]) for int64 pixel
    and sample ids."""
    jx, jy = uniforms(key, pix, samp, 124, dtype)
    lu, lv = uniforms(key, pix, samp, 125, dtype)
    x = (pix % width).to(dtype)
    y = torch.div(pix, width, rounding_mode="floor").to(dtype)
    s = (x + jx) / width
    t = 1.0 - (y + jy) / height
    u, v, lower_left, horizontal, vertical = view_frame(cam, width, height)
    r = torch.sqrt(lu)
    theta = _TWO_PI * lv
    lens = 0.5 * cam["aperture"]
    offset = (r * torch.cos(theta) * lens)[:, None] * u + (r * torch.sin(theta) * lens)[:, None] * v
    origins = cam["origin"] + offset
    dirs = _normalize(lower_left + s[:, None] * horizontal + t[:, None] * vertical - origins)
    return origins, dirs
