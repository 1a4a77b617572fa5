"""Batched ray-sphere intersection, hard (non-stochastic) form.

Counterpart of the JAX package's ``ops/intersect.py`` jnp path.  The two
inner products are written as ``[N, 3] @ [3, S]`` float32 matmuls and
|oc|^2 is expanded as |c|^2 - 2 o.c + |o|^2, the same formulation as the
JAX jnp path, so the two agree to rounding.  (The persistent kernel and its
plain version compute |oc|^2 directly instead; that formulation cancels
less on the r=1000 ground sphere, so each is compared with its own
counterpart.)  Both roots are computed; the far root is used when the near
one is behind ``t_min`` (dielectric interiors, hollow glass).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Hit(NamedTuple):
    t: torch.Tensor       # [N] f32 — closest hit parameter (t_max if miss)
    index: torch.Tensor   # [N] i64 — sphere index (0 if miss)
    hit: torch.Tensor     # [N] bool
    point: torch.Tensor   # [N, 3] f32
    normal: torch.Tensor  # [N, 3] f32 — outward (flipped for radius < 0)


# Floor for sqrt(disc): keeps d sqrt / d theta finite at grazing hits.  It
# is applied with torch.maximum against a tensor, which splits the gradient
# 0.5/0.5 at a tie as jnp.maximum does (torch.clamp would pass it whole).
_DISC_EPS = 1e-12


def ray_sphere_ts(origins, dirs, centers, radii, t_min):
    """Per (ray, sphere) candidate hit parameter: (t [N, S], valid [N, S])."""
    d_dot_c = torch.matmul(dirs, centers.T)
    o_dot_d = torch.sum(origins * dirs, -1, keepdim=True)
    tc = d_dot_c - o_dot_d
    o_dot_c = torch.matmul(origins, centers.T)
    oc2 = (
        torch.sum(centers * centers, -1)[None, :]
        - 2.0 * o_dot_c
        + torch.sum(origins * origins, -1, keepdim=True)
    )
    disc = radii[None, :] ** 2 - (oc2 - tc * tc)
    valid = disc > 0.0
    sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(_DISC_EPS)))
    t_near = tc - sq
    t = torch.where(t_near > t_min, t_near, tc + sq)
    return t, valid


def _hit_from_index(origins, dirs, idx, scene, t_min, t_max) -> Hit:
    """Hit reconstruction from a winner index (-1 = miss)."""
    hit = idx >= 0
    i = torch.clamp(idx, min=0)
    return hit_from_gathered(
        origins, dirs, i, hit, scene.centers[i], scene.radii[i], t_min, t_max
    )


def hit_from_gathered(origins, dirs, i, hit, c, r, t_min, t_max) -> Hit:
    """_hit_from_index on pre-gathered (c [N, 3], r [N]) winner attributes."""
    oc = c - origins
    tc = torch.sum(oc * dirs, -1)
    disc = r * r - (torch.sum(oc * oc, -1) - tc * tc)
    sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(_DISC_EPS)))
    t_near = tc - sq
    t = torch.where(t_near > t_min, t_near, tc + sq)
    t = torch.where(hit, t, torch.full_like(t, t_max))
    point = origins + t[:, None] * dirs
    n = (point - c) / r[:, None]
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-20)
    return Hit(t=t, index=i, hit=hit, point=point, normal=n)


def intersect_scene(origins, dirs, scene, t_min=1e-3, t_max=3.0e7) -> Hit:
    """Closest hit over all spheres; origins, dirs [N, 3] (unit dirs)."""
    t, valid = ray_sphere_ts(origins, dirs, scene.centers, scene.radii, t_min)
    ok = valid & (t > t_min) & (t < t_max)
    t_sel = torch.where(ok, t, torch.full_like(t, t_max))
    # argmin returns the first minimal index, as jnp.argmin does.
    index = torch.argmin(t_sel, dim=-1)
    t_hit = torch.gather(t_sel, 1, index[:, None])[:, 0]
    hit = t_hit < t_max
    point = origins + t_hit[:, None] * dirs
    c = scene.centers[index]
    r = scene.radii[index]
    n = (point - c) / r[:, None]
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True) + 1e-20)
    return Hit(t=t_hit, index=index, hit=hit, point=point, normal=n)
