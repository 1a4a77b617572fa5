"""Ray vs one infinite plane (counterpart of the JAX package's
``ops/plane.py``).  Plane = {p : dot(n, p) + k = 0}."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PlaneHit(NamedTuple):
    t: torch.Tensor       # [N] f32 — hit parameter (t_max if miss)
    hit: torch.Tensor     # [N] bool
    point: torch.Tensor   # [N, 3] f32
    normal: torch.Tensor  # [N, 3] f32 — face-forward (against the ray)


def ray_plane_intersection(
    origins, dirs, normal, offset, t_min=1e-3, t_max=3.0e7
) -> PlaneHit:
    """Batched ray vs single infinite plane; ``normal`` need not be unit."""
    n = torch.as_tensor(normal, dtype=torch.float32, device=origins.device)
    n = n / torch.sqrt(torch.sum(n * n) + 1e-20)
    denom = torch.sum(dirs * n, dim=-1)
    num = -(torch.sum(origins * n, dim=-1) + offset)
    live = torch.abs(denom) > 1e-8
    # Parallel rays never hit; keep the division finite.
    t = num / torch.where(live, denom, torch.ones_like(denom))
    hit = live & (t > t_min) & (t < t_max)
    t = torch.where(hit, t, torch.full_like(t, t_max))
    point = origins + t[:, None] * dirs
    face = torch.where(denom[:, None] > 0, -n, n)
    return PlaneHit(t=t, hit=hit, point=point, normal=face.expand_as(point))
