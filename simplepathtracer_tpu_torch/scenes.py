"""Scene generators (counterpart of the JAX package's ``scenes.py``).

The deterministic scenes are the same tables as the JAX package's.  The
random scenes (``cover_scene``, ``random_scene``) draw from a
``torch.Generator`` seeded with an int, with the JAX package's
distributions; the two packages give different spheres for the same seed.
Random scenes keep a fixed sphere budget and turn rejected slots into dead
spheres (tiny radius, far below the ground); ``compact_scene`` drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import Material, Scene, resolve_device

# Reference sky: initColor {137,207,240}/255 scaled by (dir.y+1)/2.
REF_SKY_HI = np.array([137.0, 207.0, 240.0], np.float32) / 255.0
REF_SKY_LO = np.zeros(3, np.float32)
# Shirley sky: lerp(white, (.5,.7,1), (dir.y+1)/2).
SHIRLEY_SKY_LO = np.array([1.0, 1.0, 1.0], np.float32)
SHIRLEY_SKY_HI = np.array([0.5, 0.7, 1.0], np.float32)

_DEAD_CENTER = (0.0, -2e6, 0.0)


def _scene_from_arrays(centers, radii, albedo, material, fuzz, ior, sky_lo,
                       sky_hi, device):
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Scene(
        centers=f32(centers), radii=f32(radii), albedo=f32(albedo),
        material=torch.as_tensor(np.asarray(material, np.int32), device=device),
        fuzz=f32(fuzz), ior=f32(ior), sky_lo=f32(sky_lo), sky_hi=f32(sky_hi),
    )


def simple_scene(device=None) -> Scene:
    """One Lambertian sphere + ground sphere."""
    return _scene_from_arrays(
        centers=[[0.0, -100.5, 1.0], [0.0, 0.0, 1.0]],
        radii=[100.0, 0.5],
        albedo=[[0.5, 0.5, 0.5], [0.7, 0.3, 0.3]],
        material=[Material.LAMBERTIAN, Material.LAMBERTIAN],
        fuzz=[0.0, 0.0], ior=[1.5, 1.5],
        sky_lo=SHIRLEY_SKY_LO, sky_hi=SHIRLEY_SKY_HI, device=device,
    )


def three_sphere_scene(hollow_glass: bool = True, device=None) -> Scene:
    """Lambertian / metal / dielectric trio, optionally with hollow glass (a
    nested negative-radius sphere)."""
    centers = [[0.0, -100.5, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [-1.0, 0.0, 1.0]]
    radii = [100.0, 0.5, 0.5, 0.5]
    albedo = [[0.8, 0.8, 0.0], [0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [1.0, 1.0, 1.0]]
    material = [Material.LAMBERTIAN, Material.LAMBERTIAN, Material.METAL, Material.DIELECTRIC]
    fuzz = [0.0, 0.0, 0.2, 0.0]
    ior = [1.5, 1.5, 1.5, 1.5]
    if hollow_glass:
        centers.append([-1.0, 0.0, 1.0])
        radii.append(-0.4)
        albedo.append([1.0, 1.0, 1.0])
        material.append(Material.DIELECTRIC)
        fuzz.append(0.0)
        ior.append(1.5)
    return _scene_from_arrays(
        centers, radii, albedo, material, fuzz, ior,
        SHIRLEY_SKY_LO, SHIRLEY_SKY_HI, device,
    )


def reference_scene(device=None) -> Scene:
    """The reference's hard-coded 3x3 grid scene (ground r=1e3)."""
    colors = np.array(
        [
            [30, 144, 255], [10, 255, 110], [110, 10, 255], [255, 100, 230],
            [200, 255, 110], [210, 10, 255], [255, 100, 150], [50, 255, 200],
            [10, 210, 255], [255, 100, 220],
        ],
        np.float32,
    ) / 255.0
    centers = np.array(
        [
            [0, -1e3 - 0.5, 0],
            [-1, 0, 0], [0, 0, 0], [1, 0, 0],
            [-1, 1, 0], [0, 1, 0], [1, 1, 0],
            [-1, 2, 0], [0, 2, 0], [1, 2, 0],
        ],
        np.float32,
    )
    radii = np.array([1e3] + [0.5] * 9, np.float32)
    M = Material
    material = [
        M.LAMBERTIAN, M.LAMBERTIAN, M.METAL, M.LAMBERTIAN, M.LAMBERTIAN,
        M.DIELECTRIC, M.LAMBERTIAN, M.LAMBERTIAN, M.METAL, M.LAMBERTIAN,
    ]
    fuzz = np.full(10, 0.01, np.float32)
    fuzz[2] = 0.0
    ior = np.full(10, 1.5, np.float32)
    return _scene_from_arrays(
        centers, radii, colors, material, fuzz, ior, REF_SKY_LO, REF_SKY_HI, device
    )


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * torch.rand(shape, generator=gen)).numpy()


def _fill_budget(fixed, rand, n_rand, pad_val):
    """Fixed spheres, then the random slots padded to ``n_rand`` with
    ``pad_val``."""
    rand = np.asarray(rand)
    pad = n_rand - rand.shape[0]
    if pad > 0:
        rand = np.concatenate([rand, np.full((pad,) + rand.shape[1:], pad_val, rand.dtype)])
    return np.concatenate([np.asarray(fixed, rand.dtype), rand])


def random_scene(seed: int = 0, max_spheres: int = 512, device=None) -> Scene:
    """The reference's randomized lattice scene, static-shape: ground r=1e4
    (the reference's r=1e6 bands in f32), three r=3 feature spheres and a
    z in [0, 20) step-1.25 lattice with a widening x bound, 50% spawn,
    radius U(0.3, 0.5), jitter U(0, 0.3), overlap rejection against the
    feature spheres and the draw min(round(U(0.5, 6)), 3) for the material.
    """
    gen = torch.Generator().manual_seed(int(seed))
    fixed_centers = np.array([[0, -1e4, 0], [0, 3, 10], [5, 3, 5], [-7, 3, 14]], np.float32)
    fixed_radii = np.array([1e4, 3, 3, 3], np.float32)
    fixed_albedo = np.array(
        [[30, 144, 255], [255, 255, 255], [230, 230, 230], [223, 55, 132]], np.float32
    ) / 255.0
    fixed_mat = np.array(
        [Material.LAMBERTIAN, Material.DIELECTRIC, Material.METAL, Material.LAMBERTIAN],
        np.int32,
    )
    fixed_fuzz = np.array([0.0, 0.0, 0.01, 0.0], np.float32)

    zs, xs = [], []
    for z in np.arange(0.0, 20.0, 1.25):
        bound = abs(z) * 0.85
        for x in np.arange(-5.0 - bound, 6.0 + bound, 1.25):
            zs.append(z)
            xs.append(x)
    n_rand = max_spheres - len(fixed_radii)
    xs, zs = np.array(xs[:n_rand], np.float32), np.array(zs[:n_rand], np.float32)
    n = len(xs)

    spawn = _uniform(gen, (n,)) > 0.5
    radius = _uniform(gen, (n,), 0.3, 0.5)
    jitter = _uniform(gen, (n, 2), 0.0, 0.3)
    centers = np.stack([xs + jitter[:, 0], radius, zs + jitter[:, 1]], -1)
    gap = (
        np.linalg.norm(centers[:, None, :] - fixed_centers[None, 1:, :], axis=-1)
        - radius[:, None] - fixed_radii[None, 1:]
    )
    ok = np.all(gap >= 0.5, axis=-1) & spawn
    albedo = _uniform(gen, (n, 3))
    draw = np.clip(np.round(_uniform(gen, (n,), 0.5, 6.0)), 1, 3).astype(np.int32)
    ref_to_ours = np.array(
        [Material.LAMBERTIAN, Material.METAL, Material.DIELECTRIC, Material.LAMBERTIAN],
        np.int32,
    )
    material = ref_to_ours[draw]
    fuzz = _uniform(gen, (n,)) * (_uniform(gen, (n,)) > 0.2)
    centers = np.where(ok[:, None], centers, np.asarray(_DEAD_CENTER, np.float32))
    radius = np.where(ok, radius, 1e-4).astype(np.float32)
    return _scene_from_arrays(
        _fill_budget(fixed_centers, centers, n_rand, -2e6),
        _fill_budget(fixed_radii, radius, n_rand, 1e-4),
        _fill_budget(fixed_albedo, albedo, n_rand, 0.0),
        _fill_budget(fixed_mat, material, n_rand, 0),
        _fill_budget(fixed_fuzz, fuzz.astype(np.float32), n_rand, 0.0),
        np.full(max_spheres, 1.5, np.float32),
        REF_SKY_LO, REF_SKY_HI, device,
    )


def cover_scene(seed: int = 0, max_spheres: int = 512, device=None) -> Scene:
    """Shirley's cover scene: ground r=1000 + 3 feature spheres + a 22x22
    jittered grid of r=0.2 spheres (diffuse 80% / metal 15% / glass 5%),
    slots within 0.9 of (4, 0.2, 0) rejected."""
    gen = torch.Generator().manual_seed(int(seed))
    fixed_centers = np.array([[0, -1000, 0], [0, 1, 0], [-4, 1, 0], [4, 1, 0]], np.float32)
    fixed_radii = np.array([1000, 1, 1, 1], np.float32)
    fixed_albedo = np.array(
        [[0.5, 0.5, 0.5], [1, 1, 1], [0.4, 0.2, 0.1], [0.7, 0.6, 0.5]], np.float32
    )
    fixed_mat = np.array(
        [Material.LAMBERTIAN, Material.DIELECTRIC, Material.LAMBERTIAN, Material.METAL],
        np.int32,
    )
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
    material = np.where(
        mat_draw < 0.8, Material.LAMBERTIAN,
        np.where(mat_draw < 0.95, Material.METAL, Material.DIELECTRIC),
    ).astype(np.int32)
    diff_albedo = _uniform(gen, (n, 3)) * _uniform(gen, (n, 3))
    metal_albedo = _uniform(gen, (n, 3), 0.5, 1.0)
    albedo = np.where((material == Material.METAL)[:, None], metal_albedo, diff_albedo)
    albedo = np.where((material == Material.DIELECTRIC)[:, None], 1.0, albedo).astype(np.float32)
    fuzz = (_uniform(gen, (n,), 0.0, 0.5) * (material == Material.METAL)).astype(np.float32)

    centers = np.where(ok[:, None], centers, np.asarray(_DEAD_CENTER, np.float32))
    radius = np.where(ok, 0.2, 1e-4).astype(np.float32)
    return _scene_from_arrays(
        _fill_budget(fixed_centers, centers, n_rand, -2e6),
        _fill_budget(fixed_radii, radius, n_rand, 1e-4),
        _fill_budget(fixed_albedo, albedo, n_rand, 0.0),
        _fill_budget(fixed_mat, material, n_rand, 0),
        _fill_budget(fixed_fuzz, fuzz, n_rand, 0.0),
        np.full(max_spheres, 1.5, np.float32),
        SHIRLEY_SKY_LO, SHIRLEY_SKY_HI, device,
    )


def with_ground_plane(
    scene: Scene,
    normal=(0.0, 1.0, 0.0),
    point=(0.0, -0.5, 0.0),
    albedo=(246 / 255.0, 219 / 255.0, 219 / 255.0),
) -> Scene:
    """Attach a Lambertian infinite plane (the reference's plane constants
    by default) on the scene's device."""
    dev = scene.device
    n = torch.as_tensor(normal, dtype=torch.float32, device=dev)
    n = n / torch.linalg.norm(n)
    k = -torch.dot(n, torch.as_tensor(point, dtype=torch.float32, device=dev))
    plane7 = torch.cat(
        [n, k.reshape(1), torch.as_tensor(albedo, dtype=torch.float32, device=dev)]
    )
    return scene.replace(plane=plane7)


def smallpt_scene(device=None) -> Scene:
    """K. Beason's smallpt Cornell box (smallpt.cpp's ``spheres[]``) without
    its black front wall: five walls of radius 1e5, a mirror and a glass
    sphere of radius 16.5, and the r = 600 ceiling light of emission 12,
    under a black sky.  The dropped front wall sits between smallpt's
    pinhole and the box (smallpt starts its camera rays 140 units out); a
    path leaving through the open front reads 0 here as it does there.
    Mirror: metal, fuzz 0; glass: dielectric, ior 1.5."""
    lam, met, die = Material.LAMBERTIAN, Material.METAL, Material.DIELECTRIC
    walls = [  # smallpt's Left, Right, Back, Bottom, Top
        ((1e5 + 1, 40.8, 81.6), (0.75, 0.25, 0.25)),
        ((-1e5 + 99, 40.8, 81.6), (0.25, 0.25, 0.75)),
        ((50, 40.8, 1e5), (0.75, 0.75, 0.75)),
        ((50, 1e5, 81.6), (0.75, 0.75, 0.75)),
        ((50, -1e5 + 81.6, 81.6), (0.75, 0.75, 0.75)),
    ]
    centers = [c for c, _ in walls] + [(27, 16.5, 47), (73, 16.5, 78), (50, 681.6 - 0.27, 81.6)]
    albedo = [a for _, a in walls] + [(0.999, 0.999, 0.999)] * 2 + [(0.0, 0.0, 0.0)]
    scene = _scene_from_arrays(
        centers=centers, radii=[1e5] * 5 + [16.5, 16.5, 600.0], albedo=albedo,
        material=[lam] * 5 + [met, die, lam], fuzz=[0.0] * 8, ior=[1.5] * 8,
        sky_lo=np.zeros(3, np.float32), sky_hi=np.zeros(3, np.float32), device=device,
    )
    emission = np.zeros((8, 3), np.float32)
    emission[7] = 12.0
    return scene.replace(emission=torch.as_tensor(emission, device=scene.device))


def compact_scene(scene: Scene, pad_multiple: int = 4) -> Scene:
    """Drop dead padding slots, live spheres first in their original order,
    padded up to ``pad_multiple`` with a repeated dead slot (the emission
    table, where there is one, follows)."""
    radii = scene.radii.cpu().numpy()
    centers = scene.centers.cpu().numpy()
    live = (np.abs(radii) > 1e-3) & (centers[:, 1] > -1e6)
    order = np.argsort(~live, kind="stable")
    n_live = int(live.sum())
    n_keep = -(-max(n_live, 1) // pad_multiple) * pad_multiple
    keep = torch.as_tensor(order[:n_keep], device=scene.device)
    return scene.replace(
        centers=scene.centers[keep], radii=scene.radii[keep],
        albedo=scene.albedo[keep], material=scene.material[keep],
        fuzz=scene.fuzz[keep], ior=scene.ior[keep],
        emission=None if scene.emission is None else scene.emission[keep],
    )


SCENES = {
    "simple": lambda seed=0, device=None, **kw: simple_scene(device=device),
    "three_sphere": lambda seed=0, device=None, **kw: three_sphere_scene(device=device, **kw),
    "reference": lambda seed=0, device=None, **kw: reference_scene(device=device),
    "random": lambda seed=0, device=None, **kw: random_scene(seed, device=device, **kw),
    "cover": lambda seed=0, device=None, **kw: cover_scene(seed, device=device, **kw),
    "smallpt": lambda seed=0, device=None, **kw: smallpt_scene(device=device),
}
