"""The forward path trace of scenes whose spheres emit light (hard
silhouettes): what a lit frame's radiance sums are.

A copy of ``forward.trace`` with one change, the emission term: at every
sphere hit the path adds its throughput (before this hit's attenuation)
times the winner's emission, before the scatter, metal absorption, the
depth limit or Russian roulette decide whether it goes on.  A path sums
its own radiance (its emission terms in bounce order, then the sky on a
miss) and ``pixel_sums`` adds each pixel's paths in ascending sample
order.  The scan and the scatter are ``forward``'s own.

It also counts the work a frame needs: every path's segments (bounces
begun), and its threefry2x32 evaluations: 2 a path for the camera ray
(slots 124, 125), 3 a hit for the scatter's uniforms (slots 4b .. 4b+2),
and 1 a Russian-roulette draw (slot 4b+3, drawn where a path scattered
below the depth limit at a bounce b >= ``rr_start_depth``).

``lit_tables`` turns a configuration's explicit sphere table (``spheres``:
one entry a sphere, with its emission) into the tensors both sides are
handed.
"""

from __future__ import annotations

import torch

from .camera import camera_ray
from .forward import closest_hit, scatter
from .rng import bounce_uniforms, uniforms

MATERIALS = {"lambertian": 0, "metal": 1, "dielectric": 2}
# threefry2x32 evaluations: a path's camera ray, a hit's scatter.
EVALS_CAMERA = 2
EVALS_HIT = 3
# Radius from which a sphere counts as a wall (smallpt's are 1e5).
WALL = 1e4


def lit_tables(scene: dict, device, dtype=torch.float32) -> dict:
    """{name: tensor} of a configuration's explicit table: ``spheres`` (each
    {center, radius, albedo, material, fuzz, ior, emission}), ``sky_lo``,
    ``sky_hi``; the sphere count padded to ``pad_multiple`` (default 4)
    with dark slots of NaN radius, which no ray can hit."""
    sph = list(scene["spheres"])
    pad = (-len(sph)) % int(scene.get("pad_multiple", 4))
    nan = float("nan")
    sph += [{"center": [0.0, -2e6, 0.0], "radius": nan, "albedo": [0.0] * 3,
             "material": "lambertian", "fuzz": 0.0, "ior": 1.0, "emission": [0.0] * 3}] * pad

    def f(rows):
        return torch.as_tensor(rows, dtype=torch.float32, device=device).to(dtype)

    return {
        "centers": f([s["center"] for s in sph]), "radii": f([s["radius"] for s in sph]),
        "albedo": f([s["albedo"] for s in sph]),
        "material": torch.as_tensor([MATERIALS[s["material"]] for s in sph], dtype=torch.int64,
                                    device=device),
        "fuzz": f([s["fuzz"] for s in sph]), "ior": f([s["ior"] for s in sph]),
        "emission": f([s["emission"] for s in sph]),
        "sky_lo": f(scene["sky_lo"]), "sky_hi": f(scene["sky_hi"]),
    }


def live(tables: dict) -> torch.Tensor:
    """Slots a ray can hit (a finite radius)."""
    return torch.isfinite(tables["radii"]) & (tables["radii"].abs() > 1e-3)


def trace(scene: dict, cam19, key, pix, samp, cfg: dict, dtype=torch.float32, emit=True):
    """([N, 3] radiance, [N] int64 segments, {"segments", "evals",
    "roulette", "self_hits"} totals) of the paths (pix[i], samp[i]).
    ``emit=False`` leaves the emission term out (the fault the comparison
    must catch).  ``self_hits``: segments whose winner is the wall (radius
    >= ``WALL``) the ray left, at t < 1: acne of the hard test on large
    spheres."""
    t_min, t_max = float(cfg["t_min"]), float(cfg["t_max"])
    max_depth, rr_start = int(cfg["max_depth"]), int(cfg.get("rr_start_depth", 0))
    c, r = scene["centers"].to(dtype), scene["radii"].to(dtype)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    alb, emis = scene["albedo"].to(dtype), scene["emission"].to(dtype)
    mat_t, fz_t, io_t = scene["material"], scene["fuzz"].to(dtype), scene["ior"].to(dtype)
    sky = scene["sky_lo"].tolist() + scene["sky_hi"].tolist()
    n = pix.shape[0]
    dev = pix.device
    out = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    ids = torch.arange(n, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    totals = {"segments": 0, "evals": EVALS_CAMERA * n, "roulette": 0, "self_hits": 0}
    ox, oy, oz, dx, dy, dz = camera_ray(cam19, key, pix, samp, cfg["width"], cfg["height"], dtype)
    tp = [torch.ones(n, dtype=dtype, device=dev) for _ in range(3)]
    for b in range(max_depth):
        if ids.numel() == 0:
            break
        segs[ids] += 1
        totals["segments"] += int(ids.numel())
        bt, bi, hit = closest_hit(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, t_min, t_max)
        totals["self_hits"] += int((hit & (bi == prev) & (bt < 1.0) & (r[bi].abs() >= WALL)).sum())
        totals["evals"] += EVALS_HIT * int(hit.sum())
        miss = ~hit
        if bool(miss.any()):
            h = 0.5 * (dy[miss] + 1.0)
            out[ids[miss]] = out[ids[miss]] + torch.stack(
                [tp[ch][miss] * (sky[ch] + (sky[ch + 3] - sky[ch]) * h) for ch in range(3)], -1)
        if emit and bool(hit.any()):
            e = emis[bi[hit]]
            out[ids[hit]] = out[ids[hit]] + torch.stack(
                [tp[ch][hit] * e[:, ch] for ch in range(3)], -1)
        wcx, wcy, wcz, wr = cx[bi], cy[bi], cz[bi], r[bi]
        px, py, pz = ox + bt * dx, oy + bt * dy, oz + bt * dz
        nx, ny, nz = (px - wcx) / wr, (py - wcy) / wr, (pz - wcz) / wr
        inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        p_ids, s_ids = pix[ids], samp[ids]
        u = bounce_uniforms(key, p_ids, s_ids, b, dtype, n_evals=3)
        sd, is_diel, scattered = scatter(dx, dy, dz, nx, ny, nz, mat_t[bi], fz_t[bi], io_t[bi], u)
        surv = hit & scattered & (b + 1 < max_depth)
        for ch in range(3):
            tp[ch] = torch.where(surv & ~is_diel, tp[ch] * alb[bi, ch], tp[ch])
        if rr_start and b >= rr_start:
            totals["roulette"] += int(surv.sum())
            q = torch.clamp(torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]), 0.05, 1.0)
            u6, _ = uniforms(key, p_ids, s_ids, 4 * b + 3, dtype)
            surv = surv & ~(u6 >= q)
            boost = 1.0 / q
            tp = [torch.where(surv, x * boost, x) for x in tp]
        keep = surv.nonzero()[:, 0]
        ids = ids[keep]
        prev = bi[keep]
        ox, oy, oz = px[keep], py[keep], pz[keep]
        dx, dy, dz = sd[0][keep], sd[1][keep], sd[2][keep]
        tp = [x[keep] for x in tp]
    totals["evals"] += totals["roulette"]
    return out, segs, totals


def pixel_sums(scene: dict, cam19, key, pixel_ids, sample_offset: int, n_samples: int,
               cfg: dict, dtype=torch.float32, chunk_paths: int = 1 << 21, emit=True):
    """([P, 3] radiance sums over ``n_samples`` samples from
    ``sample_offset``, each pixel's samples added in ascending order; the
    totals of ``trace`` over every path)."""
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    pids = pixel_ids.to(torch.int64)
    acc = torch.zeros((p, 3), dtype=dtype, device=dev)
    totals = {"segments": 0, "evals": 0, "roulette": 0, "self_hits": 0}
    per = max(1, chunk_paths // max(1, p))
    for s0 in range(0, n_samples, per):
        c = min(per, n_samples - s0)
        pix = pids.repeat(c)
        samp = (sample_offset + s0 + torch.arange(c, device=dev)).repeat_interleave(p)
        rad, _, tot = trace(scene, cam19, key, pix, samp, cfg, dtype, emit)
        for k in totals:
            totals[k] += tot[k]
        rad = rad.reshape(c, p, 3)
        for j in range(c):
            acc = acc + rad[j]
    return acc, totals
