"""Branchless material shading (counterpart of the JAX package's
``ops/materials.py``): every ray computes the Lambertian, metal and
dielectric candidates and a select over the material id picks one."""

from __future__ import annotations

import torch

from ..types import Material
from .sampling import in_unit_ball, unit_sphere_surface


def sky_color(dirs, sky_lo, sky_hi):
    """Vertical sky gradient lerp(sky_lo, sky_hi, (dir.y + 1) / 2)."""
    s = 0.5 * (dirs[..., 1:2] + 1.0)
    return sky_lo + (sky_hi - sky_lo) * s


def _reflect(d, n):
    return d - 2.0 * torch.sum(d * n, -1, keepdim=True) * n


def _safe_normalize(v, fallback):
    n2 = torch.sum(v * v, -1, keepdim=True)
    unit = v / torch.sqrt(torch.maximum(n2, n2.new_tensor(1e-20)))
    return torch.where(n2 > 1e-12, unit, fallback)


def scatter(dirs, hit, scene, unif):
    """One surface interaction per ray: (new_dirs [N, 3], attenuation
    [N, 3], scattered [N] bool); ``scattered`` is False for metal rays
    absorbed into the surface."""
    i = hit.index
    return scatter_attrs(
        dirs, hit.normal, scene.material[i], scene.albedo[i],
        scene.fuzz[i], scene.ior[i], unif,
    )


def scatter_attrs(dirs, n, mat, albedo, fuzz, ior, unif):
    """scatter() on pre-gathered per-ray attributes; unif [N, 8]."""
    front = torch.sum(dirs * n, -1) < 0.0
    n_face = torch.where(front[:, None], n, -n)

    lam_dir = _safe_normalize(
        n_face + unit_sphere_surface(unif[:, 0], unif[:, 1]), n_face
    )

    refl = _reflect(dirs, n_face)
    metal_dir = _safe_normalize(
        refl + fuzz[:, None] * in_unit_ball(unif[:, 2], unif[:, 3], unif[:, 4]),
        n_face,
    )
    metal_ok = torch.sum(metal_dir * n_face, -1) > 0.0

    # Schlick + total internal reflection tested without a sqrt.  The
    # clamps are jnp.minimum / jnp.maximum against tensors, which split the
    # gradient 0.5/0.5 at a tie (a head-on hit has cos_t == 1 exactly), as
    # JAX does; torch.clamp would pass it whole.
    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.minimum(-torch.sum(dirs * n_face, -1), dirs.new_tensor(1.0))
    sin2 = torch.maximum(1.0 - cos_t * cos_t, dirs.new_tensor(0.0))
    cannot_refract = eta * eta * sin2 > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    reflect_prob = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    do_reflect = cannot_refract | (unif[:, 5] < reflect_prob)
    perp = eta[:, None] * (dirs + cos_t[:, None] * n_face)
    par_len = torch.sqrt(torch.maximum(1.0 - torch.sum(perp * perp, -1), dirs.new_tensor(1e-12)))
    refr = perp - par_len[:, None] * n_face
    diel_dir = torch.where(do_reflect[:, None], refl, refr)
    diel_dir = _safe_normalize(diel_dir, n_face)

    is_metal = mat == int(Material.METAL)
    is_diel = mat == int(Material.DIELECTRIC)
    new_dirs = torch.where(is_metal[:, None], metal_dir, lam_dir)
    new_dirs = torch.where(is_diel[:, None], diel_dir, new_dirs)
    attenuation = torch.where(is_diel[:, None], torch.ones_like(albedo), albedo)
    scattered = torch.where(is_metal, metal_ok, torch.ones_like(metal_ok))
    return new_dirs, attenuation, scattered
