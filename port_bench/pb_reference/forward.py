"""The forward path trace, hard silhouettes: what a frame's radiance sums are.

Each (pixel, sample) path starts at its thin-lens camera ray and bounces up
to ``max_depth`` times: the nearest sphere whose root lies in (t_min,
t_max) (first index on ties; the far root where the near one is behind
t_min), the sky gradient on a miss, and the scatter of the winner's
material (Lambertian, fuzzed metal, Schlick dielectric).  The formulation
is the forward kernel's (|oc|^2 taken directly, exp(log(u) / 3) for the
fuzz ball's radius, reciprocal square roots), so that the program and this
reference differ by rounding only.  Only the live paths are scanned at each
bounce.

``pixel_sums`` adds each pixel's samples in ascending sample order, as the
program does.  ``trace`` also counts each path's segments (bounces begun),
the work the brute-force scan of a frame needs.
"""

from __future__ import annotations

import torch

from .camera import camera_ray
from .rng import bounce_uniforms, uniforms

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
_TWO_PI = 6.2831854820251465   # 2 pi rounded to float32
_THIRD = 0.3333333432674408    # 1 / 3 rounded to float32
# (path, sphere) pairs per block of the scan.
SCAN_ELEMS = 1 << 26


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def closest_hit(ox, oy, oz, dx, dy, dz, cx, cy, cz, rad, t_min, t_max):
    """(t [N], index [N] int64, hit [N] bool) over every sphere."""
    n = ox.shape[0]
    step = max(1, SCAN_ELEMS // max(1, cx.shape[0]))
    ts, idx = [], []
    for a in range(0, n, step):
        sl = slice(a, a + step)
        ocx = cx[None, :] - ox[sl, None]
        ocy = cy[None, :] - oy[sl, None]
        ocz = cz[None, :] - oz[sl, None]
        tc = ocx * dx[sl, None] + ocy * dy[sl, None] + ocz * dz[sl, None]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        disc = (rad * rad)[None, :] - (oc2 - tc * tc)
        sq = torch.sqrt(disc)
        t_near = tc - sq
        t = torch.where(t_near > t_min, t_near, tc + sq)
        ok = (t > t_min) & (t < t_max)
        t_sel = torch.where(ok, t, torch.full_like(t, t_max))
        bi = torch.argmin(t_sel, dim=1)
        ts.append(torch.gather(t_sel, 1, bi[:, None])[:, 0])
        idx.append(bi)
    bt, bi = torch.cat(ts), torch.cat(idx)
    return bt, bi, bt < t_max


def scatter(dx, dy, dz, nx, ny, nz, mat, fz, io, u):
    """New direction, dielectric mask and survival of one surface hit."""
    front = _dot(dx, dy, dz, nx, ny, nz) < 0.0
    fs = torch.where(front, 1.0, -1.0).to(dx.dtype)
    nfx, nfy, nfz = nx * fs, ny * fs, nz * fs
    dn = _dot(dx, dy, dz, nfx, nfy, nfz)
    cos_t = torch.clamp(-dn, max=1.0)

    zl = 1.0 - 2.0 * u[0]
    rl = torch.sqrt(torch.clamp(1.0 - zl * zl, min=0.0))
    phl = _TWO_PI * u[1]
    lam = (nfx + rl * torch.cos(phl), nfy + rl * torch.sin(phl), nfz + zl)

    two_dn = 2.0 * dn
    rf = (dx - two_dn * nfx, dy - two_dn * nfy, dz - two_dn * nfz)
    zm = 1.0 - 2.0 * u[2]
    rm = torch.sqrt(torch.clamp(1.0 - zm * zm, min=0.0))
    phm = _TWO_PI * u[3]
    bscale = torch.exp(torch.log(torch.clamp(u[4], min=1e-30)) * _THIRD) * fz
    met = (rf[0] + bscale * rm * torch.cos(phm), rf[1] + bscale * rm * torch.sin(phm),
           rf[2] + bscale * zm)

    eta = torch.where(front, 1.0 / io, io)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    cannot = eta * eta * sin2 > 1.0
    r0s = (1.0 - eta) / (1.0 + eta)
    r0 = r0s * r0s
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    do_refl = cannot | (u[5] < refl_p)
    pp = (eta * (dx + cos_t * nfx), eta * (dy + cos_t * nfy), eta * (dz + cos_t * nfz))
    par = torch.sqrt(torch.clamp(1.0 - _dot(*pp, *pp), min=1e-12))
    die = tuple(torch.where(do_refl, rf[i], pp[i] - par * nf)
                for i, nf in enumerate((nfx, nfy, nfz)))

    is_metal = mat == METAL
    is_diel = mat == DIELECTRIC
    g = tuple(torch.where(is_diel, die[i], torch.where(is_metal, met[i], lam[i]))
              for i in range(3))
    g2 = _dot(*g, *g)
    ginv = torch.rsqrt(torch.clamp(g2, min=1e-20))
    deg = g2 <= 1e-12
    sd = tuple(torch.where(deg, nf, gi * ginv) for gi, nf in zip(g, (nfx, nfy, nfz)))
    scattered = ~is_metal | (_dot(*sd, nfx, nfy, nfz) > 0.0)
    return sd, is_diel, scattered


def trace(scene: dict, cam19, key, pix, samp, cfg: dict, dtype=torch.float32):
    """([N, 3] radiance, [N] int64 segments) of the paths (pix[i], samp[i])."""
    t_min, t_max = float(cfg["t_min"]), float(cfg["t_max"])
    max_depth, rr_start = int(cfg["max_depth"]), int(cfg.get("rr_start_depth", 0))
    c, r = scene["centers"].to(dtype), scene["radii"].to(dtype)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    alb = scene["albedo"].to(dtype)
    mat_t, fz_t, io_t = scene["material"], scene["fuzz"].to(dtype), scene["ior"].to(dtype)
    sky = scene["sky_lo"].tolist() + scene["sky_hi"].tolist()
    n = pix.shape[0]
    dev = pix.device
    out = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    ids = torch.arange(n, device=dev)
    ox, oy, oz, dx, dy, dz = camera_ray(cam19, key, pix, samp, cfg["width"], cfg["height"], dtype)
    tp = [torch.ones(n, dtype=dtype, device=dev) for _ in range(3)]
    for b in range(max_depth):
        if ids.numel() == 0:
            break
        segs[ids] += 1
        bt, bi, hit = closest_hit(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, t_min, t_max)
        miss = ~hit
        if bool(miss.any()):
            h = 0.5 * (dy[miss] + 1.0)
            out[ids[miss]] = torch.stack(
                [tp[ch][miss] * (sky[ch] + (sky[ch + 3] - sky[ch]) * h) for ch in range(3)], -1)
        wcx, wcy, wcz, wr = cx[bi], cy[bi], cz[bi], r[bi]
        px, py, pz = ox + bt * dx, oy + bt * dy, oz + bt * dz
        nx, ny, nz = (px - wcx) / wr, (py - wcy) / wr, (pz - wcz) / wr
        inv = torch.rsqrt(_dot(nx, ny, nz, nx, ny, nz) + 1e-20)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        p_ids, s_ids = pix[ids], samp[ids]
        u = bounce_uniforms(key, p_ids, s_ids, b, dtype, n_evals=3)
        sd, is_diel, scattered = scatter(dx, dy, dz, nx, ny, nz, mat_t[bi], fz_t[bi], io_t[bi], u)
        surv = hit & scattered & (b + 1 < max_depth)
        for ch in range(3):
            tp[ch] = torch.where(surv & ~is_diel, tp[ch] * alb[bi, ch], tp[ch])
        if rr_start and b >= rr_start:
            q = torch.clamp(torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]), 0.05, 1.0)
            u6, _ = uniforms(key, p_ids, s_ids, 4 * b + 3, dtype)
            surv = surv & ~(u6 >= q)
            boost = 1.0 / q
            tp = [torch.where(surv, x * boost, x) for x in tp]
        keep = surv.nonzero()[:, 0]
        ids = ids[keep]
        ox, oy, oz = px[keep], py[keep], pz[keep]
        dx, dy, dz = sd[0][keep], sd[1][keep], sd[2][keep]
        tp = [x[keep] for x in tp]
    return out, segs


def pixel_sums(scene: dict, cam19, key, pixel_ids, sample_offset: int, n_samples: int,
               cfg: dict, dtype=torch.float32, chunk_paths: int = 1 << 21):
    """([P, 3] radiance sums over ``n_samples`` samples from
    ``sample_offset``, each pixel's samples added in ascending order; total
    segments)."""
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    pids = pixel_ids.to(torch.int64)
    acc = torch.zeros((p, 3), dtype=dtype, device=dev)
    total = 0
    per = max(1, chunk_paths // max(1, p))
    for s0 in range(0, n_samples, per):
        c = min(per, n_samples - s0)
        pix = pids.repeat(c)
        samp = (sample_offset + s0 + torch.arange(c, device=dev)).repeat_interleave(p)
        rad, segs = trace(scene, cam19, key, pix, samp, cfg, dtype)
        total += int(segs.sum())
        rad = rad.reshape(c, p, 3)
        for j in range(c):
            acc = acc + rad[j]
    return acc, total
