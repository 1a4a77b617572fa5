"""The differentiable path trace and the fit's loss, gradient and Adam step.

A path is traced bounce by bounce over the live paths only.  At each bounce
the winner (and, under soft silhouettes, the blocker) is found by a scan
over every sphere that carries no gradient; the bounce itself is then
computed from the gathered winner's and blocker's attributes, so autograd
differentiates exactly the estimator the path tracer defines:

* hard silhouettes: the nearest sphere whose root lies in (t_min, t_max);
* soft silhouettes (``softness`` > 0): stochastic transparency.  Sphere s is
  accepted iff disc_s > logit(u7) sigma(r_s) (one coin per ray and bounce)
  and its raw root beats the validity coin t_min + logit(uv) sigma_v (the
  hard t_min for the chain's previous winner); the winner is the nearest
  accepted sphere at t = max(t_raw, t_min).  The blocker is the rejected
  sphere of largest disc / r^2 whose t beats the best accepted t before it
  in index order and whose raw root lies above t_min - 30 sigma_v.  The
  entry throughput is multiplied by den / stop_grad(den), 1 in value, with
  den = max(We Ve - [front blocker] min(We, Wb) min(Ve, Vb), 1e-2), and the
  hit's square root takes the derivative of sqrt(disc + sigma).

Sphere scenes only (no ground plane); the Schlick-coin score is off.  The
bounce is written in the kernels' formulation (|oc|^2 directly, reciprocal
square roots, exp(log(u) / 3)) and carries JAX's tie rules for maximum,
minimum and clip, so that it differs from the program by rounding only.
"""

from __future__ import annotations

import math

import torch

from .camera import camera_ray, generate_rays
from .forward import closest_hit
from .rng import bounce_uniforms, uniforms

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
_TWO_PI = 6.2831854820251465
_THIRD = 0.3333333432674408
_DISC_EPS = 1e-12
_XS_CLAMP = 30.0
_SIL_R0 = 8.0
_SIG_V0 = 0.1
SIL_P_FLOOR = 1e-2
# (path, sphere) pairs per block of the scan.
SCAN_ELEMS = 1 << 26
# Copies of the table a gathered row's cotangent is first added into.
_COPIES = 256
# Leaves of a sphere scene that carry gradients.
SCENE_LEAVES = ("centers", "radii", "albedo", "fuzz", "ior", "sky_lo", "sky_hi")
# Entries of a winner row on a miss: center 0, radius 1, albedo 0, fuzz 0,
# ior 1, material Lambertian.
_MISS = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _c(x, v):
    return x.new_tensor(v)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def silhouette_scale(softness, r):
    return (r * r) * _f32(softness * _SIL_R0) / (_f32(_SIL_R0) + torch.abs(r))


def validity_scale(softness, r):
    return torch.full_like(r, _f32(softness * _SIG_V0))


def silhouette_logit(u):
    tiny = _f32(1e-30)
    lg = torch.log(torch.clamp(u, min=tiny)) - torch.log(torch.clamp(1.0 - u, min=tiny))
    return torch.clamp(lg, -_XS_CLAMP, _XS_CLAMP)


# --------------------------------------------------------------------------
# The scans (no gradient)


def _blocks(n, s):
    step = max(1, SCAN_ELEMS // max(1, s))
    return [slice(a, a + step) for a in range(0, n, step)]


def scan_hard(o, d, tab, t_min, t_max):
    """Winner index per ray (-1 on a miss): ``forward.closest_hit``."""
    _, bi, hit = closest_hit(*o, *d, *tab.unbind(1), t_min, t_max)
    return torch.where(hit, bi, -1)


def scan_soft(o, d, u7, uv, prev, tab, soft_tab, t_min, t_max):
    """(winner index, blocker index) per ray; -1 for none.

    The validity scale is the same for every sphere, so the validity and
    gate thresholds are one number per ray; the chain's previous winner
    takes the hard t_min in its own column."""
    s_pad = tab.shape[0]
    sigv = soft_tab[0, 2]
    if not bool(torch.all(soft_tab[:, 2] == sigv)):
        raise ValueError("the validity scale must be the same for every sphere")
    gate_thr = t_min + soft_tab[0, 3]
    idx_out, blk_out = [], []
    lgt_all = silhouette_logit(u7)
    thr_v_all = t_min + silhouette_logit(uv) * sigv
    inv_r2, scale = soft_tab[:, 1], soft_tab[:, 0]
    rad = tab[:, 3]
    r2 = rad * rad
    for sl in _blocks(o[0].shape[0], s_pad):
        ocx = tab[None, :, 0] - o[0][sl, None]
        ocy = tab[None, :, 1] - o[1][sl, None]
        ocz = tab[None, :, 2] - o[2][sl, None]
        tc = ocx * d[0][sl, None] + ocy * d[1][sl, None] + ocz * d[2][sl, None]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        del ocx, ocy, ocz
        disc = r2[None, :] - (oc2 - tc * tc)
        del oc2
        sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(_DISC_EPS)))
        t_near = tc - sq
        t_raw = torch.where(t_near > t_min, t_near, tc + sq)
        del tc, sq, t_near
        t = torch.maximum(t_raw, t_raw.new_tensor(t_min))
        valc = (t_raw > thr_v_all[sl, None]) & (t_raw < t_max)
        gate = t_raw > gate_thr
        pv = prev[sl]
        rp = (pv >= 0).nonzero()[:, 0]
        if rp.numel():
            cp = pv[rp]
            tr = t_raw[rp, cp]
            valc[rp, cp] = (tr > t_min) & (tr < t_max)
            gate[rp, cp] = tr > t_min
        accept = (disc > lgt_all[sl, None] * scale[None, :]) & valc
        del valc
        t_sel = torch.where(accept, t, t.new_tensor(t_max))
        bi = torch.argmin(t_sel, dim=1)
        bt = torch.gather(t_sel, 1, bi[:, None])[:, 0]
        cmin = torch.cummin(t_sel, dim=1).values
        del t_sel
        bt_before = torch.cat([torch.full_like(cmin[:, :1], t_max), cmin[:, :-1]], dim=1)
        del cmin
        cand = ~accept & gate & (t < bt_before)
        del accept, gate, bt_before, t
        score = torch.where(cand, disc * inv_r2[None, :], disc.new_tensor(float("-inf")))
        qi = torch.argmax(score, dim=1)
        blk_out.append(torch.where(cand.any(dim=1), qi, -1))
        idx_out.append(torch.where(bt < t_max, bi, -1))
    return torch.cat(idx_out), torch.cat(blk_out)


class _Rows(torch.autograd.Function):
    """table[idx] whose backward sums each row's cotangents per sphere into
    ``_COPIES`` copies of the table first (row i into copy i mod
    ``_COPIES``), then the copies: ``index_select``'s own backward adds
    millions of rows into a few hundred with atomics that contend."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n = ctx.n_rows
        spread = idx + n * (torch.arange(idx.shape[0], device=idx.device) % _COPIES)
        out = g.new_zeros((_COPIES * n, g.shape[1])).index_add_(0, spread, g)
        return out.view(_COPIES, n, g.shape[1]).sum(0), None


def rows(table, idx):
    """table[idx], differentiable in ``table``."""
    return _Rows.apply(table, idx) if table.requires_grad else table[idx]


# --------------------------------------------------------------------------
# One differentiable bounce


def _clip30(x):
    m = torch.maximum(x, _c(x, -_XS_CLAMP))
    return torch.minimum(m, _c(x, _XS_CLAMP))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _soft_den(o, d, t, t_raw, disc, sw, r, hit, softness, blocker, t_min):
    """den of the detached ratio den / stop_grad(den)."""
    wm = hit
    w = _sigmoid(_clip30(disc / (sw + 1e-12)))
    we = torch.where(wm, w, _c(r, 1.0))
    v = _sigmoid(_clip30((t_raw - t_min) / (validity_scale(softness, r) + 1e-12)))
    ve = torch.where(wm, v, _c(r, 1.0))
    bval, bcx, bcy, bcz, br = blocker
    ocb = (bcx - o[0], bcy - o[1], bcz - o[2])
    tcb = _dot(ocb, d)
    discb = br * br - (_dot(ocb, ocb) - tcb * tcb)
    mb = _sigmoid(_clip30(discb / (silhouette_scale(softness, br) + 1e-12)))
    sqb = torch.sqrt(torch.maximum(discb, _c(r, _DISC_EPS)))
    tnb = tcb - sqb
    t_raw_b = torch.where(tnb > t_min, tnb, tcb + sqb)
    t_b = torch.maximum(t_raw_b, _c(r, t_min))
    vbv = _sigmoid(_clip30((t_raw_b - t_min) / (validity_scale(softness, br) + 1e-12)))
    fb = bval & (t_b < t)
    wb = torch.where(fb, mb, _c(r, 0.0))
    vb = torch.where(fb, vbv, _c(r, 1.0))
    blk = torch.where(fb, torch.minimum(we, wb) * torch.minimum(ve, vb), _c(r, 0.0))
    return torch.maximum(we * ve - blk, _c(r, SIL_P_FLOOR))


def bounce(o, d, tp, a9, mat, hit, u, sky6, do_rr, t_min, t_max, rr_on, softness=0.0,
           blocker=None):
    """(o', d', tp', radiance, survives) of one bounce of live paths."""
    cx, cy, cz, r, ar, ag, ab, fz, io = a9
    oc = (cx - o[0], cy - o[1], cz - o[2])
    tc = _dot(oc, d)
    disc = r * r - (_dot(oc, oc) - tc * tc)
    dmax = torch.maximum(disc, _c(r, _DISC_EPS))
    sw = None
    if softness:
        sw = silhouette_scale(softness, r)
        capped = torch.sqrt(dmax + sw)
        sq = (torch.sqrt(dmax) - capped).detach() + capped
    else:
        sq = torch.sqrt(dmax)
    t_near = tc - sq
    t_raw = torch.where(t_near > t_min, t_near, tc + sq)
    t = torch.maximum(t_raw, _c(t_raw, t_min)) if softness else t_raw
    t = torch.where(hit, t, _c(t, t_max))
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    n0 = ((p[0] - cx) / r, (p[1] - cy) / r, (p[2] - cz) / r)
    ninv = 1.0 / torch.sqrt(_dot(n0, n0) + 1e-20)
    n = tuple(x * ninv for x in n0)
    if softness:
        den = _soft_den(o, d, t, t_raw, disc, sw, r, hit, softness, blocker, t_min)
        tp = tuple(x * (den / den.detach()) for x in tp)

    front = _dot(d, n) < 0.0
    fsign = torch.where(front, 1.0, -1.0).to(r.dtype)
    nf = tuple(x * fsign for x in n)
    cos_t = torch.minimum(-_dot(d, nf), _c(r, 1.0))

    zl = 1.0 - 2.0 * u[0]
    rl = torch.sqrt(torch.maximum(1.0 - zl * zl, _c(zl, 0.0)))
    phl = _TWO_PI * u[1]
    lv = (nf[0] + rl * torch.cos(phl), nf[1] + rl * torch.sin(phl), nf[2] + zl)
    ln2 = _dot(lv, lv)
    linv = torch.rsqrt(torch.maximum(ln2, _c(zl, 1e-20)))
    lam = tuple(torch.where(ln2 <= 1e-12, a, b * linv) for a, b in zip(nf, lv))

    two_dn = 2.0 * _dot(d, nf)
    rf = tuple(di - two_dn * ni for di, ni in zip(d, nf))
    zm = 1.0 - 2.0 * u[2]
    rm = torch.sqrt(torch.maximum(1.0 - zm * zm, _c(zm, 0.0)))
    phm = _TWO_PI * u[3]
    bscale = torch.exp(torch.log(torch.maximum(u[4], _c(zm, 1e-30))) * _THIRD) * fz
    m = (rf[0] + bscale * rm * torch.cos(phm), rf[1] + bscale * rm * torch.sin(phm),
         rf[2] + bscale * zm)
    mn2 = _dot(m, m)
    minv = torch.rsqrt(torch.maximum(mn2, _c(zm, 1e-20)))
    met = tuple(torch.where(mn2 <= 1e-12, a, b * minv) for a, b in zip(nf, m))
    metal_ok = _dot(met, nf) > 0.0

    eta = torch.where(front, 1.0 / io, io)
    sin2 = torch.maximum(1.0 - cos_t * cos_t, _c(zm, 0.0))
    cannot = eta * eta * sin2 > 1.0
    r0s = (1.0 - eta) / (1.0 + eta)
    r0 = r0s * r0s
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    do_refl = cannot | (u[5] < refl_p)
    pp = tuple(eta * (di + cos_t * ni) for di, ni in zip(d, nf))
    par = torch.sqrt(torch.maximum(1.0 - _dot(pp, pp), _c(zm, 1e-12)))
    g = tuple(torch.where(do_refl, a, b - par * ni) for a, b, ni in zip(rf, pp, nf))
    gn2 = _dot(g, g)
    ginv = torch.rsqrt(torch.maximum(gn2, _c(zm, 1e-20)))
    die = tuple(torch.where(gn2 <= 1e-12, a, b * ginv) for a, b in zip(nf, g))

    is_metal = mat == METAL
    is_diel = mat == DIELECTRIC
    sd = tuple(torch.where(is_diel, c, torch.where(is_metal, b, a))
               for a, b, c in zip(lam, met, die))
    att = tuple(torch.where(is_diel, torch.ones_like(a), a) for a in (ar, ag, ab))
    scattered = metal_ok | ~is_metal

    s01 = 0.5 * (d[1] + 1.0)
    sk = tuple(sky6[c] + (sky6[c + 3] - sky6[c]) * s01 for c in range(3))
    miss_f = torch.where(hit, 0.0, 1.0).to(r.dtype)
    rad = tuple(tp[c] * sk[c] * miss_f for c in range(3))

    surv = hit & scattered
    nt = tuple(torch.where(surv, tp[c] * att[c], tp[c]) for c in range(3))
    no = tuple(torch.where(hit, pc, oc_) for pc, oc_ in zip(p, o))
    nd = tuple(torch.where(surv, s, dd) for s, dd in zip(sd, d))
    if rr_on:
        m2 = torch.maximum(torch.maximum(nt[0], nt[1]), nt[2])
        qq = torch.minimum(_c(m2, 1.0), torch.maximum(_c(m2, 0.05), m2))
        surv = surv & ~(do_rr & (u[6] >= qq))
        boost = do_rr & surv
        nt = tuple(torch.where(boost, x / qq, x) for x in nt)
    return no, nd, nt, rad, surv


# --------------------------------------------------------------------------
# Paths


def scan_tables(scene: dict, softness: float):
    """The scan's [S, 4] (cx, cy, cz, r) table and, soft, its [S, 4] table of
    silhouette scale, 1 / r^2, validity scale and -30 x validity scale;
    values only."""
    with torch.no_grad():
        c, r = scene["centers"].detach(), scene["radii"].detach()
        tab = torch.cat([c, r[:, None]], 1)
        soft_tab = None
        if softness > 0.0:
            sigv = validity_scale(softness, r)
            soft_tab = torch.stack([silhouette_scale(softness, r), 1.0 / (r * r), sigv,
                                    -30.0 * sigv], 1)
    return tab, soft_tab


def trace(scene: dict, key, pix, samp, cfg: dict, softness: float, cam=None, cam19=None,
          dtype=torch.float32):
    """([N, 3] radiance of the paths (pix[i], samp[i]), differentiable in the
    scene's and, given ``cam``, the camera's leaves; total segments).

    ``cam`` (a dict of leaves): rays from ``generate_rays``; else the fixed
    camera block ``cam19``."""
    t_min, t_max = float(cfg["t_min"]), float(cfg["t_max"])
    max_depth, rr_start = int(cfg["max_depth"]), int(cfg.get("rr_start_depth", 0))
    dev = pix.device
    n = pix.shape[0]
    tab, soft_tab = scan_tables(scene, softness)
    tab = tab.to(dtype)
    soft_tab = soft_tab.to(dtype) if soft_tab is not None else None
    table = torch.cat([scene["centers"], scene["radii"][:, None], scene["albedo"],
                       scene["fuzz"][:, None], scene["ior"][:, None]], 1).to(dtype)
    mat_t = scene["material"]
    sky6 = torch.cat([scene["sky_lo"], scene["sky_hi"]]).to(dtype)
    miss = torch.tensor(_MISS, dtype=dtype, device=dev)
    if cam is not None:
        origins, dirs = generate_rays(cam, cfg["width"], cfg["height"], key, pix, samp, dtype)
        o, d = origins.unbind(1), dirs.unbind(1)
    else:
        ray = camera_ray(cam19, key, pix, samp, cfg["width"], cfg["height"], dtype)
        o, d = ray[:3], ray[3:]
    tp = tuple(torch.ones(n, dtype=dtype, device=dev) for _ in range(3))
    ids = torch.arange(n, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rr_on = bool(rr_start)
    segments = 0
    rads, rad_ids = [], []
    for b in range(max_depth):
        if ids.numel() == 0:
            break
        segments += ids.numel()
        p_ids, s_ids = pix[ids], samp[ids]
        u = bounce_uniforms(key, p_ids, s_ids, b, dtype)
        with torch.no_grad():
            od, dd = tuple(x.detach() for x in o), tuple(x.detach() for x in d)
            if softness > 0.0:
                _, uv = uniforms(key, p_ids, s_ids, 128 + b, dtype)
                idx, bidx = scan_soft(od, dd, u[7], uv, prev, tab, soft_tab, t_min, t_max)
            else:
                idx, bidx = scan_hard(od, dd, tab, t_min, t_max), None
        hit = idx >= 0
        i = idx.clamp(min=0)
        hm = hit[:, None]
        a9 = torch.where(hm, rows(table, i), miss).unbind(1)
        mat = torch.where(hit, mat_t[i], 0)
        blocker = None
        if softness > 0.0:
            bv = bidx >= 0
            j = bidx.clamp(min=0)
            brow = torch.where(bv[:, None], rows(table[:, :4], j),
                               torch.zeros((), dtype=dtype, device=dev))
            blocker = (bv, *brow.unbind(1))
        do_rr = torch.full((ids.numel(),), b >= rr_start, device=dev)
        o, d, tp, rad, surv = bounce(o, d, tp, a9, mat, hit, u, sky6, do_rr, t_min, t_max,
                                     rr_on, softness, blocker)
        rads.append(torch.stack(rad, 1))
        rad_ids.append(ids)
        surv = surv & (b + 1 < max_depth)
        keep = surv.nonzero()[:, 0]
        ids = ids[keep]
        prev = torch.where(hit, idx, -1)[keep]
        o, d, tp = (tuple(x[keep] for x in v) for v in (o, d, tp))
    out = torch.zeros((n, 3), dtype=dtype, device=dev).index_add(0, torch.cat(rad_ids),
                                                                  torch.cat(rads))
    return out, segments


def pixel_sums(scene, key, pixel_ids, s0: int, s1: int, cfg, softness, cam=None, cam19=None,
               dtype=torch.float32, chunk_paths: int = 1 << 21, pullback=None):
    """[P, 3] radiance sums of samples [s0, s1) (detached) and the segments.

    ``pullback`` (a [P, 3] cotangent): each chunk's sums are pulled back
    through ``torch.autograd.backward``, accumulating into the leaves'
    ``.grad``."""
    p = pixel_ids.shape[0]
    dev = pixel_ids.device
    pids = pixel_ids.to(torch.int64)
    pos = torch.arange(p, device=dev)
    acc = torch.zeros((p, 3), dtype=dtype, device=dev)
    segments = 0
    per = max(1, chunk_paths // max(1, p))
    for a in range(s0, s1, per):
        c = min(per, s1 - a)
        pix = pids.repeat(c)
        samp = (a + torch.arange(c, device=dev)).repeat_interleave(p)
        with torch.set_grad_enabled(pullback is not None):
            rad, segs = trace(scene, key, pix, samp, cfg, softness, cam=cam, cam19=cam19,
                              dtype=dtype)
            part = torch.zeros((p, 3), dtype=dtype, device=dev).index_add(0, pos.repeat(c), rad)
        if pullback is not None and part.requires_grad:
            torch.autograd.backward(part, pullback)
        acc = acc + part.detach()
        segments += segs
    return acc, segments


# --------------------------------------------------------------------------
# The fit's step


def loss_and_grad(leaves: dict, static: dict, target, key, cfg: dict, softness: float,
                  camera: bool, decoupled: bool, dtype=torch.float32,
                  chunk_paths: int = 1 << 21):
    """(loss, {leaf: gradient}, segments) of one fit step.

    ``leaves``: the fitted leaves (scene leaves, or with ``camera`` the
    camera's); ``static``: {"scene": ..., "camera": ...} holding the rest.
    ``decoupled``: the value is the full-spp MSE and the gradient the
    independent-pair estimator (residual of samples [0, spp / 2), detached,
    times the pullback of [spp / 2, spp)); else the gradient of the MSE of
    all samples."""
    scene = dict(static["scene"])
    cam = dict(static["camera"])
    width, height, spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
    p = width * height
    dev = target.device
    pixel_ids = torch.arange(p, device=dev)
    t = target.reshape(-1, 3).to(dtype)
    params = {k: v.detach().clone().to(dtype).requires_grad_(True) for k, v in leaves.items()}

    def cast(v):
        v = v.detach()
        return v.to(dtype) if v.is_floating_point() else v

    fixed_scene = {k: cast(v) for k, v in scene.items()}
    fixed_cam = {k: cast(v) for k, v in cam.items()}
    if camera:
        fixed_cam.update({k: v.detach() for k, v in params.items()})
        live_scene, live_cam = fixed_scene, dict(fixed_cam, **params)
    else:
        fixed_scene.update({k: v.detach() for k, v in params.items()})
        live_scene, live_cam = dict(fixed_scene, **params), None
    cam19 = None
    if not camera:
        from .camera import camera_constants
        cam19 = camera_constants(fixed_cam, width, height)
    kw = dict(cfg=cfg, softness=softness, dtype=dtype, chunk_paths=chunk_paths)
    cam_fixed_arg = fixed_cam if camera else None
    if decoupled:
        h = max(spp // 2, 1)
        acc_a, seg_a = pixel_sums(fixed_scene, key, pixel_ids, 0, h, cam=cam_fixed_arg,
                                  cam19=cam19, **kw)
        resid = (2.0 * (acc_a / h - t) / t.numel()) / (spp - h)
        acc_b, seg_b = pixel_sums(live_scene, key, pixel_ids, h, spp, cam=live_cam,
                                  cam19=cam19, pullback=resid, **kw)
        value = torch.mean(((acc_a + acc_b) / spp - t) ** 2)
        segments = seg_a + seg_b
    else:
        acc, seg_a = pixel_sums(fixed_scene, key, pixel_ids, 0, spp, cam=cam_fixed_arg,
                                cam19=cam19, **kw)
        value = torch.mean((acc / spp - t) ** 2)
        ct = 2.0 * (acc / spp - t) / t.numel() / spp
        _, seg_b = pixel_sums(live_scene, key, pixel_ids, 0, spp, cam=live_cam, cam19=cam19,
                              pullback=ct, **kw)
        segments = seg_a + seg_b
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in params.items()}
    return float(value), grads, segments


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with the fit's mask: a masked
    entry's gradient is zeroed before the update and its value held at the
    start's after."""

    def __init__(self, params: dict, lr: float, mask: dict | None = None):
        self.lr, self.mask = lr, mask or {}
        self.start = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for k, p in params.items():
            g = grads[k]
            if k in self.mask:
                g = g * self.mask[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            q = p - self.lr * mhat / (torch.sqrt(vhat) + eps)
            if k in self.mask:
                q = torch.where(self.mask[k] > 0, q, self.start[k])
            out[k] = q
        return out


def masked(grads: dict, mask: dict | None) -> dict:
    """The gradients as the optimizer gets them: masked entries zeroed."""
    mask = mask or {}
    return {k: g * mask[k] if k in mask else g for k, g in grads.items()}


def norm(x) -> float:
    return math.sqrt(float(torch.sum(x.double() * x.double())))
