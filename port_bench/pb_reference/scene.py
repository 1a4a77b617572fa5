"""The benchmark's scenes (frozen copy of the cover generator).

``cover_tables`` draws P. Shirley's cover scene (Ray Tracing in One Weekend,
v3.2.3, section 13.1): a ground sphere of radius 1000, three radius-1
feature spheres (glass, diffuse, metal) and a 22 x 22 jittered grid of
radius-0.2 spheres, 80% diffuse, 15% metal, 5% glass, slots within 0.9 of
(4, 0.2, 0) rejected.  A fixed budget of slots is drawn, rejected slots
become dead spheres, and ``compact`` drops them (live spheres first, in
order, padded to a multiple of 4 with a dead slot).  The distributions are
the program's; the tables are the benchmark's input to both sides.  A
configuration names its draw (``seed``): the scene is the deployment, the
same in every run, so that a run's seed changes the paths' random streams
and not the work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
SHIRLEY_SKY_LO = np.array([1.0, 1.0, 1.0], np.float32)
SHIRLEY_SKY_HI = np.array([0.5, 0.7, 1.0], np.float32)
_DEAD_CENTER = (0.0, -2e6, 0.0)


class Tables(NamedTuple):
    """A sphere scene as NumPy tables: centers [S, 3], radii [S], albedo
    [S, 3], material [S] int32, fuzz [S], ior [S], sky_lo [3], sky_hi [3]."""

    centers: np.ndarray
    radii: np.ndarray
    albedo: np.ndarray
    material: np.ndarray
    fuzz: np.ndarray
    ior: np.ndarray
    sky_lo: np.ndarray
    sky_hi: np.ndarray

    def live(self) -> np.ndarray:
        """Slots that can be hit: not the dead filler."""
        return (np.abs(self.radii) > 1e-3) & (self.centers[:, 1] > -1e6)


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * torch.rand(shape, generator=gen)).numpy()


def _fill(fixed, rand, n_rand, pad_val):
    rand = np.asarray(rand)
    pad = n_rand - rand.shape[0]
    if pad > 0:
        rand = np.concatenate([rand, np.full((pad,) + rand.shape[1:], pad_val, rand.dtype)])
    return np.concatenate([np.asarray(fixed, rand.dtype), rand])


def cover_tables(seed: int, max_spheres: int = 512) -> Tables:
    """The cover scene drawn with a CPU ``torch.Generator`` seeded by
    ``seed`` (any integer below 2^64)."""
    gen = torch.Generator().manual_seed(int(seed))
    fixed_centers = np.array([[0, -1000, 0], [0, 1, 0], [-4, 1, 0], [4, 1, 0]], np.float32)
    fixed_radii = np.array([1000, 1, 1, 1], np.float32)
    fixed_albedo = np.array(
        [[0.5, 0.5, 0.5], [1, 1, 1], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]], np.float32
    )
    fixed_mat = np.array([LAMBERTIAN, DIELECTRIC, LAMBERTIAN, METAL], np.int32)
    fixed_fuzz = np.zeros(4, np.float32)

    n_rand = max_spheres - 4
    grid = [(a, b) for a in range(-11, 11) for b in range(-11, 11)][:n_rand]
    n = len(grid)
    ga = np.array([g[0] for g in grid], np.float32)
    gb = np.array([g[1] for g in grid], np.float32)

    jit_xy = _uniform(gen, (n, 2)) * np.float32(0.9)
    centers = np.stack([ga + jit_xy[:, 0], np.full(n, 0.2, np.float32), gb + jit_xy[:, 1]], -1)
    ok = np.linalg.norm(centers - np.array([4.0, 0.2, 0.0], np.float32), axis=-1) > 0.9

    mat_draw = _uniform(gen, (n,))
    material = np.where(mat_draw < 0.8, LAMBERTIAN,
                        np.where(mat_draw < 0.95, METAL, DIELECTRIC)).astype(np.int32)
    diff_albedo = _uniform(gen, (n, 3)) * _uniform(gen, (n, 3))
    metal_albedo = _uniform(gen, (n, 3), 0.5, 1.0)
    albedo = np.where((material == METAL)[:, None], metal_albedo, diff_albedo)
    albedo = np.where((material == DIELECTRIC)[:, None], 1.0, albedo).astype(np.float32)
    fuzz = (_uniform(gen, (n,), 0.0, 0.5) * (material == METAL)).astype(np.float32)

    centers = np.where(ok[:, None], centers, np.asarray(_DEAD_CENTER, np.float32))
    radius = np.where(ok, 0.2, 1e-4).astype(np.float32)
    return Tables(
        centers=_fill(fixed_centers, centers, n_rand, -2e6).astype(np.float32),
        radii=_fill(fixed_radii, radius, n_rand, 1e-4).astype(np.float32),
        albedo=_fill(fixed_albedo, albedo, n_rand, 0.0).astype(np.float32),
        material=_fill(fixed_mat, material, n_rand, 0).astype(np.int32),
        fuzz=_fill(fixed_fuzz, fuzz, n_rand, 0.0).astype(np.float32),
        ior=np.full(max_spheres, 1.5, np.float32),
        sky_lo=SHIRLEY_SKY_LO.copy(), sky_hi=SHIRLEY_SKY_HI.copy(),
    )


def compact(t: Tables, pad_multiple: int = 4) -> Tables:
    """Live spheres first in their order, padded to ``pad_multiple`` with a
    dead slot."""
    live = t.live()
    order = np.argsort(~live, kind="stable")
    n_keep = -(-max(int(live.sum()), 1) // pad_multiple) * pad_multiple
    keep = order[:n_keep]
    return t._replace(centers=t.centers[keep], radii=t.radii[keep], albedo=t.albedo[keep],
                      material=t.material[keep], fuzz=t.fuzz[keep], ior=t.ior[keep])


SCENES = {"cover": cover_tables}


def make_tables(scene: dict) -> Tables:
    """The tables a configuration's ``scene`` block names: {"generator":
    name, "seed": the draw, "max_spheres": n, "compact": bool}."""
    gen = SCENES[scene["generator"]]
    t = gen(int(scene["seed"]), max_spheres=int(scene.get("max_spheres", 512)))
    return compact(t) if scene.get("compact", True) else t


def to_device(t: Tables, device, dtype=torch.float32) -> dict:
    """{name: tensor} of the tables on ``device`` (material int64)."""
    out = {}
    for k, v in t._asdict().items():
        if k == "material":
            out[k] = torch.as_tensor(v, dtype=torch.int64, device=device)
        else:
            out[k] = torch.as_tensor(v, dtype=torch.float32, device=device).to(dtype)
    return out
