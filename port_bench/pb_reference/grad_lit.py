"""The differentiable path trace of scenes whose spheres emit light, and the
fit's loss and gradient there.

``grad.trace`` with one change, the emission term of ``forward_lit``: at
every sphere hit a path adds its entry throughput times the winner's
emission, before the scatter, absorption, the depth limit or Russian
roulette decide whether it goes on.  Under soft silhouettes the entry
throughput carries the detached ratio den / stop_grad(den) (``grad``'s
``_soft_den``, 1 in value), so the term's gradient also reaches the
silhouettes of the spheres between the path and the light.  The emission
table is a leaf (``SCENE_LEAVES``): d radiance / d emission is the
throughput arriving at the hit.  Everything else (the scans, the bounce,
the rows' gather, Adam, the mask) is ``grad``'s own.

Where this departs from K. Beason's smallpt, it departs as the program and
``configs/smallpt.json``'s ``assumed`` do:

* Russian roulette from ``rr_start_depth`` on the throughput's largest
  channel, floored at 0.05 (smallpt's is on the surface colour's);
* the dielectric's Schlick coin: reflect with probability Re, weight 1
  (smallpt takes P = .25 + .5 Re with weights Re / P and Tr / (1 - P) and
  splits both branches at depth <= 2);
* a box filter, one jitter a sample (smallpt tent-filters 2 x 2
  subpixels);
* float32 in place of double (``t_min`` 0.1 in place of eps 1e-4); the
  module turns TF32 off for the card's matrix products, so float32 holds.

It also counts each pass's work: segments (bounces begun) and
threefry2x32 evaluations (2 a path for the camera ray, 4 a segment for the
bounce's 8 uniforms, and under soft silhouettes 1 more for the validity
coin of slot 128 + b).

Faults for the comparison's limits (``control_fit_lit.py``): ``emit``
"backward" keeps the term in the value but not in the gradient (the
adjoint without emission), "none" leaves it out of both.
"""

from __future__ import annotations

import torch

from . import grad
from .camera import camera_constants, camera_ray
from .grad import Adam, masked, norm, rows, scan_hard, scan_soft, scan_tables  # noqa: F401
from .rng import bounce_uniforms, uniforms

# Float32 means float32: no TF32 passes for a matrix product on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCENE_LEAVES = grad.SCENE_LEAVES + ("emission",)
# threefry2x32 evaluations: a path's camera ray, a segment's bounce
# uniforms, a soft segment's validity coin.
EVALS_CAMERA = 2
EVALS_SEGMENT = 4
EVALS_SOFT = 1
EMIT_MODES = ("both", "backward", "none")


def _emission_term(o, d, tp, a9, hit, e, t_min, t_max, softness, blocker):
    """The bounce's emission term (r, g, b): the entry throughput (soft:
    times den / stop_grad(den), recomputed from the winner's attributes as
    ``grad.bounce`` computes it) times the winner's emission on hit lanes."""
    if softness:
        cx, cy, cz, r = a9[:4]
        oc = (cx - o[0], cy - o[1], cz - o[2])
        tc = grad._dot(oc, d)
        disc = r * r - (grad._dot(oc, oc) - tc * tc)
        dmax = torch.maximum(disc, grad._c(r, grad._DISC_EPS))
        sw = grad.silhouette_scale(softness, r)
        capped = torch.sqrt(dmax + sw)
        sq = (torch.sqrt(dmax) - capped).detach() + capped
        t_near = tc - sq
        t_raw = torch.where(t_near > t_min, t_near, tc + sq)
        t = torch.maximum(t_raw, grad._c(t_raw, t_min))
        t = torch.where(hit, t, grad._c(t, t_max))
        den = grad._soft_den(o, d, t, t_raw, disc, sw, r, hit, softness, blocker, t_min)
        tp = tuple(x * (den / den.detach()) for x in tp)
    zero = torch.zeros((), dtype=tp[0].dtype, device=tp[0].device)
    return tuple(torch.where(hit, tp[c] * e[:, c], zero) for c in range(3))


def trace(scene: dict, key, pix, samp, cfg: dict, softness: float, cam19, dtype=torch.float32,
          emit: str = "both"):
    """([N, 3] radiance of the paths (pix[i], samp[i]), differentiable in the
    scene's leaves, its emission included; {"segments", "evals"}).
    ``emit``: one of ``EMIT_MODES``."""
    if emit not in EMIT_MODES:
        raise ValueError(f"emit must be one of {EMIT_MODES}")
    t_min, t_max = float(cfg["t_min"]), float(cfg["t_max"])
    max_depth, rr_start = int(cfg["max_depth"]), int(cfg.get("rr_start_depth", 0))
    dev = pix.device
    n = pix.shape[0]
    tab, soft_tab = scan_tables(scene, softness)
    tab = tab.to(dtype)
    soft_tab = soft_tab.to(dtype) if soft_tab is not None else None
    table = torch.cat([scene["centers"], scene["radii"][:, None], scene["albedo"],
                       scene["fuzz"][:, None], scene["ior"][:, None]], 1).to(dtype)
    emis = scene["emission"].to(dtype)
    mat_t = scene["material"]
    sky6 = torch.cat([scene["sky_lo"], scene["sky_hi"]]).to(dtype)
    miss = torch.tensor(grad._MISS, dtype=dtype, device=dev)
    ray = camera_ray(cam19, key, pix, samp, cfg["width"], cfg["height"], dtype)
    o, d = ray[:3], ray[3:]
    tp = tuple(torch.ones(n, dtype=dtype, device=dev) for _ in range(3))
    ids = torch.arange(n, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rr_on = bool(rr_start)
    work = {"segments": 0, "evals": EVALS_CAMERA * n}
    rads, rad_ids = [], []
    for b in range(max_depth):
        if ids.numel() == 0:
            break
        work["segments"] += ids.numel()
        work["evals"] += ids.numel() * (EVALS_SEGMENT + (EVALS_SOFT if softness > 0.0 else 0))
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
        lit = None
        if emit != "none":
            e = torch.where(hm, rows(emis, i), torch.zeros((), dtype=dtype, device=dev))
            lit = _emission_term(o, d, tp, a9, hit, e, t_min, t_max, softness, blocker)
            if emit == "backward":
                lit = tuple(x.detach() for x in lit)
        do_rr = torch.full((ids.numel(),), b >= rr_start, device=dev)
        o, d, tp, rad, surv = grad.bounce(o, d, tp, a9, mat, hit, u, sky6, do_rr, t_min, t_max,
                                          rr_on, softness, blocker)
        if lit is not None:
            rad = tuple(r + x for r, x in zip(rad, lit))
        rads.append(torch.stack(rad, 1))
        rad_ids.append(ids)
        surv = surv & (b + 1 < max_depth)
        keep = surv.nonzero()[:, 0]
        ids = ids[keep]
        prev = torch.where(hit, idx, -1)[keep]
        o, d, tp = (tuple(x[keep] for x in v) for v in (o, d, tp))
    out = torch.zeros((n, 3), dtype=dtype, device=dev).index_add(0, torch.cat(rad_ids),
                                                                  torch.cat(rads))
    return out, work


def pixel_sums(scene, key, pixel_ids, s0: int, s1: int, cfg, softness, cam19,
               dtype=torch.float32, chunk_paths: int = 1 << 21, pullback=None,
               emit: str = "both"):
    """[P, 3] radiance sums of samples [s0, s1) (detached) and their work
    ({"segments", "evals"}).  ``pullback`` (a [P, 3] cotangent): each chunk's
    sums are pulled back through ``torch.autograd.backward``, accumulating
    into the leaves' ``.grad``."""
    p = pixel_ids.shape[0]
    dev = pixel_ids.device
    pids = pixel_ids.to(torch.int64)
    pos = torch.arange(p, device=dev)
    acc = torch.zeros((p, 3), dtype=dtype, device=dev)
    work = {"segments": 0, "evals": 0}
    per = max(1, chunk_paths // max(1, p))
    for a in range(s0, s1, per):
        c = min(per, s1 - a)
        pix = pids.repeat(c)
        samp = (a + torch.arange(c, device=dev)).repeat_interleave(p)
        with torch.set_grad_enabled(pullback is not None):
            rad, w = trace(scene, key, pix, samp, cfg, softness, cam19, dtype, emit)
            part = torch.zeros((p, 3), dtype=dtype, device=dev).index_add(0, pos.repeat(c), rad)
        if pullback is not None and part.requires_grad:
            torch.autograd.backward(part, pullback)
        acc = acc + part.detach()
        for k in work:
            work[k] += w[k]
    return acc, work


def loss_and_grad(leaves: dict, static: dict, target, key, cfg: dict, softness: float,
                  decoupled: bool, dtype=torch.float32, chunk_paths: int = 1 << 21,
                  emit: str = "both"):
    """(loss, {leaf: gradient}, work) of one fit step of scene leaves
    (``grad.loss_and_grad``'s, with emission).  ``work``: {"segments",
    "evals"} of every pass (the value's and the pullback's samples) and
    ``"segments_grad"``, the pullback's segments alone."""
    scene = dict(static["scene"])
    width, height, spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
    p = width * height
    dev = target.device
    pixel_ids = torch.arange(p, device=dev)
    t = target.reshape(-1, 3).to(dtype)
    params = {k: v.detach().clone().to(dtype).requires_grad_(True) for k, v in leaves.items()}

    def cast(v):
        v = v.detach()
        return v.to(dtype) if v.is_floating_point() else v

    fixed = {k: cast(v) for k, v in scene.items()}
    fixed.update({k: v.detach() for k, v in params.items()})
    live = dict(fixed, **params)
    cam19 = camera_constants({k: cast(v) for k, v in static["camera"].items()}, width, height)
    kw = dict(cfg=cfg, softness=softness, cam19=cam19, dtype=dtype, chunk_paths=chunk_paths,
              emit=emit)
    h = max(spp // 2, 1) if decoupled else spp
    acc_a, w_a = pixel_sums(fixed, key, pixel_ids, 0, h, **kw)
    if decoupled:
        resid = (2.0 * (acc_a / h - t) / t.numel()) / (spp - h)
        acc_b, w_b = pixel_sums(live, key, pixel_ids, h, spp, pullback=resid, **kw)
        value = torch.mean(((acc_a + acc_b) / spp - t) ** 2)
    else:
        value = torch.mean((acc_a / spp - t) ** 2)
        ct = 2.0 * (acc_a / spp - t) / t.numel() / spp
        _, w_b = pixel_sums(live, key, pixel_ids, 0, spp, pullback=ct, **kw)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in params.items()}
    work = {k: w_a[k] + w_b[k] for k in w_a}
    work["segments_grad"] = w_b["segments"]
    return float(value), grads, work
