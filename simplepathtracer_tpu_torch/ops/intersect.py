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

from . import closest_hit as _ch
from .sampling import _f32


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


def intersect_scene_pallas(origins, dirs, alive, scene, t_min=1e-3, t_max=3.0e7) -> Hit:
    """Closest hit through the closest-hit kernel (``closest_hit.closest_hit``,
    the JAX ``_closest_hit_kernel``'s formulation) on detached inputs; the
    differentiable t, point and normal are rebuilt by ``_hit_from_index``.
    ``alive`` [N] bool: dead rays miss."""
    idx, _ = _ch.closest_hit(origins.detach(), dirs.detach(), alive, scene.centers.detach(),
                             scene.radii.detach(), t_min=t_min, t_max=t_max)
    return _hit_from_index(origins, dirs, idx.to(torch.int64), scene, t_min, t_max)


# ---------------------------------------------------------------------------
# Two-sided soft silhouettes (the JAX package's ``ops/intersect.py``, round 5)

# Logistic clamp of every silhouette sigmoid: saturates it exactly in f32.
_XS_CLAMP = 30.0
# Radius cap of the silhouette band: soft * r^2 for r << R0, soft * |r| * R0
# for giant (ground) spheres.
_SIL_R0 = 8.0
# The detached Schlick-coin ratio in soft scatters (ops/materials.py).  Off
# by default, as in the JAX package; the eager path honours it, the
# gradient kernels raise NotImplementedError when it is on.
SIL_FRESNEL = False
# Floor on the realized-outcome probability p = We Ve - M of the detached
# ratio p / stop_grad(p): caps the per-sample weight |dp| / p at 1 / floor.
SIL_P_FLOOR = 1e-2
# Validity band scale sigma_v = softness * _SIG_V0 (radius-independent).
_SIG_V0 = 0.1


def silhouette_scale(softness, r):
    """Silhouette band scale sigma(r) = soft * r^2 * R0 / (R0 + |r|): disc /
    sigma is the opacity logit and logit(u) * sigma the acceptance
    threshold.  Same op order as the JAX package (the coins are knife
    edges)."""
    return (r * r) * _f32(softness * _SIL_R0) / (_f32(_SIL_R0) + torch.abs(r))


def crossing_scale(softness, r):
    """t-space band scale of the plane-vs-sphere crossing coin:
    soft * |r| * R0 / (R0 + |r|)."""
    a = torch.abs(r)
    return _f32(softness) * a * _f32(_SIL_R0) / (_f32(_SIL_R0) + a)


def validity_scale(softness, r):
    """t-space band scale of the candidate-validity coin: soft * 0.1 for
    every sphere (``r`` gives the shape)."""
    return torch.full_like(r, _f32(softness * _SIG_V0))


def grad_capped_sqrt(dmax, scale):
    """sqrt(dmax) in value (up to one rounding of sg(x - y) + y, kept as the
    JAX package writes it: its forward is not bit-equal to sqrt) with the
    gradient of sqrt(dmax + scale), capped at 1 / (2 sqrt(scale))."""
    exact = torch.sqrt(dmax)
    capped = torch.sqrt(dmax + scale)
    return (exact - capped).detach() + capped


def silhouette_logit(u):
    """Acceptance-coin logit log(u) - log(1 - u), clamped to +-30 (u = 0
    accepts anything inside the band)."""
    tiny = _f32(1e-30)
    lg = torch.log(torch.clamp(u, min=tiny)) - torch.log(torch.clamp(1.0 - u, min=tiny))
    return torch.clamp(lg, -_XS_CLAMP, _XS_CLAMP)


def intersect_scene_soft(origins, dirs, u, uv, scene, t_min, t_max, softness,
                         prev_idx=None):
    """Stochastic-transparency closest hit (the JAX package's
    ``intersect_scene_soft``): (Hit, blocker_idx [N] int64).

    Sphere s is accepted iff disc_s > logit(u) * sigma(r_s) (one shared
    coin per ray) and its raw root beats the validity coin t_min +
    logit(uv) * sigma_v; ``prev_idx`` (the chain's previous sphere winner,
    -1 for none) keeps the hard t > t_min gate.  The winner is the nearest
    accepted sphere at the clamped t = max(t_raw, t_min), first on ties.
    The blocker is the rejected sphere with the largest disc / r^2 (first
    on ties) whose clamped t beats the best accepted t before it in index
    order (an exclusive running minimum) and whose raw root lies above
    t_min - 30 sigma_v; -1 if none.  Matmul form at full precision, as the
    hard ``intersect_scene``."""
    centers, radii = scene.centers, scene.radii
    n, s = origins.shape[0], radii.shape[0]
    d_dot_c = torch.matmul(dirs, centers.T)
    o_dot_d = torch.sum(origins * dirs, -1, keepdim=True)
    tc = d_dot_c - o_dot_d
    o_dot_c = torch.matmul(origins, centers.T)
    oc2 = (
        torch.sum(centers * centers, -1)[None, :]
        - 2.0 * o_dot_c
        + torch.sum(origins * origins, -1, keepdim=True)
    )
    r2 = radii * radii
    disc = r2[None, :] - (oc2 - tc * tc)
    scale = silhouette_scale(softness, radii)
    thr = silhouette_logit(u)[:, None] * scale[None, :]
    sq = grad_capped_sqrt(torch.maximum(disc, disc.new_tensor(_DISC_EPS)), scale[None, :])
    t_near = tc - sq
    t_raw = torch.where(t_near > t_min, t_near, tc + sq)
    sigv = validity_scale(softness, radii)
    thr_v = t_min + silhouette_logit(uv)[:, None] * sigv[None, :]
    gate_lo = (t_min - 30.0 * sigv)[None, :]
    if prev_idx is not None:
        is_prev = prev_idx[:, None] == torch.arange(s, device=radii.device)[None, :]
        thr_v = torch.where(is_prev, thr_v.new_tensor(_f32(t_min)), thr_v)
        gate_lo = torch.where(is_prev, thr_v.new_tensor(_f32(t_min)), gate_lo)
    t = torch.maximum(t_raw, t_raw.new_tensor(t_min))
    accept = (disc > thr) & (t_raw > thr_v) & (t_raw < t_max)
    t_sel = torch.where(accept, t, t.new_tensor(t_max))
    index = torch.argmin(t_sel, dim=-1)
    t_hit = torch.gather(t_sel, 1, index[:, None])[:, 0]
    hit = t_hit < t_max

    # Blocker: exclusive running minimum of the accepted t in index order.
    cmin = torch.cummin(t_sel.detach(), dim=1).values
    bt_before = torch.cat(
        [torch.full((n, 1), t_max, dtype=cmin.dtype, device=cmin.device), cmin[:, :-1]], dim=1
    )
    rej_front = (~accept) & (t_raw > gate_lo) & (t < bt_before)
    score = torch.where(rej_front, (disc / r2[None, :]).detach(),
                        disc.new_tensor(float("-inf")))
    bidx = torch.argmax(score, dim=-1)
    blocker_idx = torch.where(rej_front.any(dim=-1), bidx, torch.full_like(bidx, -1))

    point = origins + t_hit[:, None] * dirs
    c = centers[index]
    r = radii[index]
    nrm = (point - c) / r[:, None]
    nrm = nrm / torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True) + 1e-20)
    return Hit(t=t_hit, index=index, hit=hit, point=point, normal=nrm), blocker_idx


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
