"""One differentiable hard bounce on flat per-lane tensors, and its adjoint.

Counterpart of the JAX package's ``ops/pallas_grad.py:bounce_tile`` (hard
branch: no soft silhouette, no blocker) and of the scatter it runs,
``ops/pallas_common.py:scatter_tiles``.  The JAX kernels differentiate that
function with ``jax.vjp`` inside the kernel body; CUDA has no autodiff, so
the port writes the adjoint by hand:

* ``bounce_tile`` is the forward, in plain PyTorch ops that autograd can
  differentiate (ties and selects follow JAX's rules, see below).
* ``bounce_tile_adjoint`` is the hand-written reverse pass, written op for
  op as the CUDA ``__device__`` adjoint in ``csrc/grad_regen.cu``
  (``bounce_adjoint``).  The tests hold it against ``torch.autograd`` on
  ``bounce_tile`` and against ``jax.vjp`` on the JAX ``bounce_tile``.

Gradient rules (JAX's):

* a select (``jnp.where``) sends the cotangent to the chosen branch only;
* ``maximum``, ``minimum`` and ``clip`` split it 0.5/0.5 where the operands
  tie (grey throughput in Russian roulette, ``tp == 1`` after glass on the
  clip's upper bound, a head-on hit's ``cos_t == 1``);
* ``mat``, ``hit``, ``alive``, the uniforms ``u`` and ``do_rr`` are
  constants;
* on a plane lane (``plane_mask``) the winner's (cx, cy, cz) slots carry the
  plane's unit normal and the r slot its offset k; the offset's cotangent is
  the r slot's, the normal slots' cotangents are dropped by the caller;
* ``emission`` (the winner's emitted radiance per lane, or None): a live
  sphere hit adds the entry throughput times it to the bounce's radiance,
  and its cotangent is the radiance cotangent times that throughput.

Every argument is a flat [N] float32 tensor (or a tuple of them), except
the masks (bool) and ``mat`` (int).  ``sky6`` entries may be 0-d tensors.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..types import Material
from .sampling import _f32
from .intersect import (
    _SIL_R0,
    _XS_CLAMP,
    SIL_P_FLOOR,
    crossing_scale,
    silhouette_scale,
    validity_scale,
)

_TWO_PI = float(np.float32(2.0 * np.pi))
_THIRD = float(np.float32(1.0 / 3.0))
_DISC_EPS = 1e-12


def _c(x, v):
    """The constant v as a 0-d tensor beside x (maximum/minimum against a
    tensor keep JAX's tie rule)."""
    return x.new_tensor(v)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _forward(o3, d3, tp3, a9, mat, hit, alive, u, sky6, do_rr, t_min, t_max,
             rr_on, plane_mask, softness=0.0, blocker=None, plane4=None,
             cross_loser=None, fresnel=False, emission=None):
    """The forward with every intermediate the adjoint reads."""
    f = SimpleNamespace()
    ox, oy, oz = o3
    dx, dy, dz = d3
    cx, cy, cz, r, ar, ag, ab, fz, io = a9
    f.o, f.d, f.tp, f.c, f.r = o3, d3, tp3, (cx, cy, cz), r
    f.soft = softness
    # Hit reconstruction from the winner's attributes.
    f.oc = (cx - ox, cy - oy, cz - oz)
    f.tc = _dot(f.oc, d3)
    f.oc2 = _dot(f.oc, f.oc)
    f.disc = r * r - (f.oc2 - f.tc * f.tc)
    dmax = torch.maximum(f.disc, _c(r, _DISC_EPS))
    if softness:
        # Grazing and phantom winners are common under the soft scheme: the
        # derivative of the sqrt is capped at the band scale (value-exact).
        f.sw = silhouette_scale(softness, r)
        f.capped = torch.sqrt(dmax + f.sw)
        f.sq = (torch.sqrt(dmax) - f.capped).detach() + f.capped
    else:
        f.sq = torch.sqrt(dmax)
    t_near = f.tc - f.sq
    f.use_near = t_near > t_min
    t = torch.where(f.use_near, t_near, f.tc + f.sq)
    f.t_raw = t
    if softness:
        # A coin-validated marginal candidate hits at t_min, never behind.
        t = torch.maximum(t, _c(t, t_min))
    t = torch.where(hit, t, _c(t, t_max))
    f.pm = plane_mask
    if plane_mask is not None:
        # True plane intersection: (cx, cy, cz) = unit normal, r = offset.
        f.den_p = dx * cx + dy * cy + dz * cz
        f.live_d = torch.abs(f.den_p) > 1e-8
        f.den_s = torch.where(f.live_d, f.den_p, _c(r, 1.0))
        f.num = -(ox * cx + oy * cy + oz * cz) - r
        t = torch.where(plane_mask, f.num / f.den_s, t)
        psgn = torch.where(f.den_p > 0.0, -1.0, 1.0)
    f.t = t
    f.p = (ox + t * dx, oy + t * dy, oz + t * dz)
    f.q = (f.p[0] - cx, f.p[1] - cy, f.p[2] - cz)
    f.n0 = (f.q[0] / r, f.q[1] / r, f.q[2] / r)
    f.sn = torch.sqrt(_dot(f.n0, f.n0) + 1e-20)
    f.ninv = 1.0 / f.sn
    n = tuple(x * f.ninv for x in f.n0)
    if plane_mask is not None:
        f.psgn = psgn
        n = tuple(torch.where(plane_mask, psgn * ci, ni) for ci, ni in zip(f.c, n))
    f.n = n
    if softness:
        # Two-sided silhouettes: the entry throughput times the detached
        # ratio den / stop_grad(den) == 1 (values untouched).
        f.s = _soft_forward(f, hit, alive, softness, blocker, plane4,
                            cross_loser, t_min, t_max)
        tp3 = tuple(x * (f.s.den / f.s.den.detach()) for x in tp3)

    # scatter_tiles: all three materials, selected by mat.
    front = _dot(d3, n) < 0.0
    f.front = front
    f.fsign = torch.where(front, 1.0, -1.0)
    nf = tuple(x * f.fsign for x in n)
    f.nf = nf
    f.dnf = _dot(d3, nf)
    one = _c(dx, 1.0)
    f.cos_t = torch.minimum(-f.dnf, one)

    zl = 1.0 - 2.0 * u[0]
    rl = torch.sqrt(torch.maximum(1.0 - zl * zl, _c(zl, 0.0)))
    phl = _TWO_PI * u[1]
    f.l = (nf[0] + rl * torch.cos(phl), nf[1] + rl * torch.sin(phl), nf[2] + zl)
    f.ln2 = _dot(f.l, f.l)
    f.lm = torch.maximum(f.ln2, _c(zl, 1e-20))
    f.linv = torch.rsqrt(f.lm)
    f.ldeg = f.ln2 <= 1e-12
    lam = tuple(torch.where(f.ldeg, a, b * f.linv) for a, b in zip(nf, f.l))

    f.two_dn = 2.0 * _dot(d3, nf)
    f.rf = tuple(di - f.two_dn * ni for di, ni in zip(d3, nf))
    zm = 1.0 - 2.0 * u[2]
    f.rm = torch.sqrt(torch.maximum(1.0 - zm * zm, _c(zm, 0.0)))
    phm = _TWO_PI * u[3]
    f.cm, f.sm, f.zm = torch.cos(phm), torch.sin(phm), zm
    f.bs0 = torch.exp(torch.log(torch.maximum(u[4], _c(zm, 1e-30))) * _THIRD)
    f.bscale = f.bs0 * fz
    f.m = (f.rf[0] + f.bscale * f.rm * f.cm, f.rf[1] + f.bscale * f.rm * f.sm,
           f.rf[2] + f.bscale * zm)
    f.mn2 = _dot(f.m, f.m)
    f.mm = torch.maximum(f.mn2, _c(zm, 1e-20))
    f.minv = torch.rsqrt(f.mm)
    f.mdeg = f.mn2 <= 1e-12
    met = tuple(torch.where(f.mdeg, a, b * f.minv) for a, b in zip(nf, f.m))
    metal_ok = _dot(met, nf) > 0.0

    f.eta = torch.where(front, 1.0 / io, io)
    f.io = io
    sin2 = torch.maximum(1.0 - f.cos_t * f.cos_t, _c(zm, 0.0))
    f.cannot = cannot = f.eta * f.eta * sin2 > 1.0
    f.r0s = r0s = (1.0 - f.eta) / (1.0 + f.eta)
    f.r0 = r0 = r0s * r0s
    f.omc = omc = 1.0 - f.cos_t
    f.omc2 = omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    f.do_refl = cannot | (u[5] < refl_p)
    f.inner = tuple(di + f.cos_t * ni for di, ni in zip(d3, nf))
    f.pp = tuple(f.eta * x for x in f.inner)
    f.px = 1.0 - _dot(f.pp, f.pp)
    f.par = torch.sqrt(torch.maximum(f.px, _c(zm, 1e-12)))
    f.g = tuple(torch.where(f.do_refl, a, b - f.par * ni)
                for a, b, ni in zip(f.rf, f.pp, nf))
    f.gn2 = _dot(f.g, f.g)
    f.gm = torch.maximum(f.gn2, _c(zm, 1e-20))
    f.ginv = torch.rsqrt(f.gm)
    f.gdeg = f.gn2 <= 1e-12
    die = tuple(torch.where(f.gdeg, a, b * f.ginv) for a, b in zip(nf, f.g))

    f.is_metal = mat == int(Material.METAL)
    f.is_diel = mat == int(Material.DIELECTRIC)
    sd = tuple(torch.where(f.is_diel, c, torch.where(f.is_metal, b, a))
               for a, b, c in zip(lam, met, die))
    diel_at = torch.ones_like(ar)
    f.fresnel = fresnel
    if fresnel:
        # Detached Schlick-coin ratio p / stop_grad(p) == 1 on dielectric
        # lanes: p = max(p_evt, SIL_P_FLOOR), p_evt the realized branch's
        # probability (1 under total internal reflection).
        f.pevt = torch.where(f.do_refl, torch.where(cannot, 1.0, refl_p), 1.0 - refl_p)
        f.pf = torch.maximum(f.pevt, _c(zm, SIL_P_FLOOR))
        diel_at = f.pf / f.pf.detach()
    f.at = tuple(torch.where(f.is_diel, diel_at, a) for a in (ar, ag, ab))
    scattered = metal_ok | ~f.is_metal

    # Sky miss shader.
    f.s01 = 0.5 * (dy + 1.0)
    f.skw = tuple(sky6[c + 3] - sky6[c] for c in range(3))
    f.sk = tuple(sky6[c] + f.skw[c] * f.s01 for c in range(3))
    f.miss = alive & ~hit
    miss_f = torch.where(f.miss, 1.0, 0.0)
    rad = tuple(tp3[c] * f.sk[c] * miss_f for c in range(3))

    f.live = alive & hit
    if emission is not None:
        # Emitted light at a live sphere hit (the plane emits nothing),
        # through the entry throughput (soft: with the detached ratio).
        f.lit = f.live if plane_mask is None else f.live & ~plane_mask
        rad = tuple(r + torch.where(f.lit, tp3[c] * emission[c], _c(r, 0.0))
                    for c, r in enumerate(rad))
    f.surv0 = f.live & scattered
    nt = tuple(torch.where(f.surv0, tp3[c] * f.at[c], tp3[c]) for c in range(3))
    f.nt = nt
    no3 = tuple(torch.where(f.live, pc, oc) for pc, oc in zip(f.p, o3))
    nd3 = tuple(torch.where(f.surv0, s, dd) for s, dd in zip(sd, d3))
    surv = f.surv0
    f.rr_on = rr_on
    if rr_on:
        f.m1 = torch.maximum(nt[0], nt[1])
        f.m2 = torch.maximum(f.m1, nt[2])
        f.q1 = torch.maximum(_c(f.m2, 0.05), f.m2)
        f.qq = torch.minimum(_c(f.m2, 1.0), f.q1)
        surv = surv & ~(do_rr & (u[6] >= f.qq))
        f.boost = do_rr & surv
        nt = tuple(torch.where(f.boost, x / f.qq, x) for x in nt)
    return f, (no3, nd3, nt, rad, torch.where(surv, 1.0, 0.0))


def _clip30(x):
    """jnp.clip(x, -30, 30) = minimum(maximum(x, -30), 30): (the maximum,
    the clipped value)."""
    m = torch.maximum(x, _c(x, -_XS_CLAMP))
    return m, torch.minimum(m, _c(x, _XS_CLAMP))


def _sigmoid(x):
    """1 / (1 + exp(-x)), written as the JAX package's bounce_tile writes
    it: (exp(-x), the sigmoid)."""
    e = torch.exp(-x)
    return e, 1.0 / (1.0 + e)


def _soft_forward(f, hit, alive, softness, blocker, plane4, cross_loser,
                  t_min, t_max):
    """The realized scan outcome's probability ``den`` and every
    intermediate of it (the JAX package's bounce_tile, silhouette branch):

      den = max(We Ve - [fb] min(We, Wb) min(Ve, Vb), SIL_P_FLOOR) * qf

    We, Ve: the winner's opacity and validity sigmoids (1 off sphere-win
    lanes); Wb, Vb: the blocker's, where it is a front blocker whose
    clamped t lies before the winner's (fb); qf (plane scenes): the
    crossing coin's probability, P(sphere beats plane) on sphere-win lanes
    with a plane hit, P(plane beats the loser) on plane lanes whose blocker
    slot holds the crossing loser (``cross_loser``, recorded by the
    forward)."""
    s = SimpleNamespace()
    ox, oy, oz = f.o
    dx, dy, dz = f.d
    r = f.r
    pm = f.pm
    eps = _c(r, _DISC_EPS)
    # Winner: opacity and validity.
    s.sw1 = f.sw + 1e-12
    s.xr = f.disc / s.sw1
    s.xm, xc = _clip30(s.xr)
    s.ew, s.w = _sigmoid(xc)
    s.wm = alive & hit if pm is None else alive & hit & ~pm
    s.we = torch.where(s.wm, s.w, _c(r, 1.0))
    s.v1 = validity_scale(softness, r) + 1e-12
    s.vr = (f.t_raw - t_min) / s.v1
    s.vm, vc = _clip30(s.vr)
    s.ev, s.v = _sigmoid(vc)
    s.ve = torch.where(s.wm, s.v, _c(r, 1.0))
    # Blocker: opacity, validity and clamped t.
    bval, bcx, bcy, bcz, br = blocker
    s.br = br
    s.ocb = (bcx - ox, bcy - oy, bcz - oz)
    s.tcb = _dot(s.ocb, f.d)
    ocb2 = _dot(s.ocb, s.ocb)
    s.discb = br * br - (ocb2 - s.tcb * s.tcb)
    s.sb = silhouette_scale(softness, br)
    s.sb1 = s.sb + 1e-12
    s.xbr = s.discb / s.sb1
    s.xbm, xbc = _clip30(s.xbr)
    s.eb, s.mb = _sigmoid(xbc)
    s.dmaxb = torch.maximum(s.discb, eps)
    s.sqb = torch.sqrt(s.dmaxb)
    tnb = s.tcb - s.sqb
    s.use_nb = tnb > t_min
    t_raw_b = torch.where(s.use_nb, tnb, s.tcb + s.sqb)
    t_b = torch.maximum(t_raw_b, _c(r, t_min))
    s.vb1 = validity_scale(softness, br) + 1e-12
    s.vbr = (t_raw_b - t_min) / s.vb1
    s.vbm, vbc = _clip30(s.vbr)
    s.evb, s.vbv = _sigmoid(vbc)
    s.bon = bval & alive
    front = s.bon & ~cross_loser if plane4 is not None else s.bon
    s.fb = front & (t_b < f.t)
    s.wb = torch.where(s.fb, s.mb, _c(r, 0.0))
    s.vb = torch.where(s.fb, s.vbv, _c(r, 1.0))
    s.mw = torch.minimum(s.we, s.wb)
    s.mv = torch.minimum(s.ve, s.vb)
    blk = torch.where(s.fb, s.mw * s.mv, _c(r, 0.0))
    s.pout = s.we * s.ve - blk
    s.den1 = torch.maximum(s.pout, _c(r, SIL_P_FLOOR))
    s.den = s.den1
    s.plane = plane4 is not None
    if s.plane:
        pnx, pny, pnz, pk = plane4
        s.pn = (pnx, pny, pnz)
        den4 = dx * pnx + dy * pny + dz * pnz
        s.live4 = torch.abs(den4) > 1e-8
        s.den4s = torch.where(s.live4, den4, _c(r, 1.0))
        s.num4 = -(ox * pnx + oy * pny + oz * pnz) - pk
        tpl4 = s.num4 / s.den4s
        pl_ok = s.live4 & (tpl4 > t_min) & (tpl4 < t_max)
        # Sphere-win lanes: P(sphere beats plane) from the winner's t.
        s.sxw1 = crossing_scale(softness, r) + 1e-12
        s.qsn = tpl4 - f.t
        s.qsr = s.qsn / s.sxw1
        s.qsm, qsc = _clip30(s.qsr)
        s.eqs, s.qs = _sigmoid(qsc)
        s.qsel = alive & hit & ~pm & pl_ok
        qf = torch.where(s.qsel, s.qs, _c(r, 1.0))
        # Plane lanes with a crossing loser: P(plane beats it), from the
        # loser's capped-sqrt clamped t.
        s.cappedb = torch.sqrt(s.dmaxb + s.sb)
        sqbx = (s.sqb - s.cappedb).detach() + s.cappedb
        tnbx = s.tcb - sqbx
        s.use_nbx = tnbx > t_min
        s.t_raw_bx = torch.where(s.use_nbx, tnbx, s.tcb + sqbx)
        tbx = torch.maximum(s.t_raw_bx, _c(r, t_min))
        s.sxb1 = crossing_scale(softness, br) + 1e-12
        s.qpn = tbx - f.t
        s.qpr = s.qpn / s.sxb1
        s.qpm, qpc = _clip30(s.qpr)
        s.eqp, s.qp = _sigmoid(qpc)
        s.cl = s.bon & cross_loser & pm
        s.qf = torch.where(s.cl, s.qp, qf)
        s.den = s.den1 * s.qf
    return s


def bounce_tile(o3, d3, tp3, a9, mat, hit, alive, u, sky6, do_rr, *,
                t_min: float, t_max: float, rr_on: bool, plane_mask=None,
                softness: float = 0.0, blocker=None, plane4=None,
                cross_loser=None, fresnel: bool = False, emission=None):
    """One differentiable bounce.  Returns (o'3, d'3, tp'3, rad3, surv_f):
    next origin, direction and throughput, this bounce's radiance (sky on a
    live miss; with ``emission``, the winner's emitted radiance per lane,
    the entry throughput times it on a live sphere hit) and 1.0 where the
    path goes on.

    ``softness`` > 0: two-sided soft silhouettes.  The winner's hit t takes
    the capped-sqrt root clamped to t_min, and the entry throughput is
    scaled by den / stop_grad(den) (``_soft_forward``).  Then ``blocker`` =
    (valid mask, cx, cy, cz, r) of the lane's blocker; on plane scenes
    ``plane4`` = (unit normal x, y, z, offset k; the offset differentiable)
    and ``cross_loser`` = the lanes whose blocker is the sphere that lost
    the plane crossing coin (the others' blockers are rejected front
    spheres).

    ``fresnel`` (soft configs with ``intersect.SIL_FRESNEL`` on): a
    dielectric hit's attenuation is the detached Schlick-coin ratio
    p / stop_grad(p) (the JAX package's ``scatter_tiles(fresnel_score=)``),
    1 in value, whose gradient is the realized coin outcome's score."""
    return _forward(o3, d3, tp3, a9, mat, hit, alive, u, sky6, do_rr,
                    t_min, t_max, rr_on, plane_mask, softness, blocker,
                    plane4, cross_loser, fresnel, emission)[1]


def _wmax(a, b):
    """d max(a, b) / da under JAX's rule: 1 if a > b, 0.5 on a tie, else 0."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _wmin(a, b):
    """d min(a, b) / da: 1 if a < b, 0.5 on a tie, else 0."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _sel(cond, a):
    """a where cond, else 0 (NaN-safe: the other lanes never read a)."""
    return torch.where(cond, a, torch.zeros_like(a))


def _rsqrt_adj(g_inv, inv, m, x, floor):
    """Cotangent of x through inv = rsqrt(max(x, floor)) (JAX: rsqrt'(m) =
    -0.5 * inv / m, max split at a tie)."""
    return g_inv * (-0.5 * (inv / m)) * _wmax(x, x.new_tensor(floor))


def _sig_adj(g, sig, e):
    """Cotangent of x through sig = 1 / (1 + e), e = exp(-x)."""
    return (g * (sig * sig)) * e


def _clip_adj(g, m, x):
    """Cotangent of x through minimum(m, 30), m = maximum(x, -30)."""
    return (g * _wmin(m, m.new_tensor(_XS_CLAMP))) * _wmax(x, x.new_tensor(-_XS_CLAMP))


def _scale_adj(g, r, softness):
    """Cotangent of r through silhouette_scale = ((r r) c) / (R0 + |r|)."""
    c = _f32(softness * _SIL_R0)
    num = (r * r) * c
    den = _f32(_SIL_R0) + torch.abs(r)
    g_num = g / den
    g_den = ((-g) * num) * (1.0 / (den * den))
    return 2.0 * ((g_num * c) * r) + g_den * torch.sign(r)


def _xscale_adj(g, r, softness):
    """Cotangent of r through crossing_scale = ((soft |r|) R0) / (R0 + |r|)."""
    a = torch.abs(r)
    num = (_f32(softness) * a) * _f32(_SIL_R0)
    den = _f32(_SIL_R0) + a
    g_num = g / den
    g_den = ((-g) * num) * (1.0 / (den * den))
    return ((g_num * _f32(_SIL_R0)) * _f32(softness) + g_den) * torch.sign(r)


def _fresnel_adjoint(f, g_att):
    """Cotangents of (cos_t, eta) through the dielectric attenuation
    p / stop_grad(p) from its cotangent ``g_att``: p = max(p_evt, floor),
    p_evt = reflect_prob on a reflection (1 under total internal
    reflection) or 1 - reflect_prob on a refraction, reflect_prob =
    r0 + (1 - r0) (1 - cos_t)^5, r0 = ((1 - eta) / (1 + eta))^2."""
    g_pevt = (g_att / f.pf) * _wmax(f.pevt, f.pevt.new_tensor(SIL_P_FLOOR))
    g_rp = torch.where(f.do_refl, torch.where(f.cannot, 0.0, g_pevt), -g_pevt)
    omr0 = 1.0 - f.r0
    a1 = omr0 * f.omc2
    a2 = a1 * f.omc2
    g_a2 = g_rp * f.omc
    g_omc = g_rp * a2
    g_a1 = g_a2 * f.omc2
    g_omc2 = g_a2 * a1 + g_a1 * omr0
    g_r0 = g_rp - g_a1 * f.omc2
    g_omc = g_omc + 2.0 * (g_omc2 * f.omc)
    g_r0s = 2.0 * (g_r0 * f.r0s)
    den = 1.0 + f.eta
    g_eta = -(g_r0s / den) + ((-g_r0s) * (1.0 - f.eta)) * (1.0 / (den * den))
    return -g_omc, g_eta


def _soft_adjoint(f, g_srat, t_min):
    """Reverse of ``_soft_forward`` from the cotangent of the ratio
    den / stop_grad(den).  Returns the cotangents of the winner's disc, raw
    root t_raw, final t, silhouette scale and crossing scale, of (o, d),
    of the blocker's (cx, cy, cz, r) and of the plane offset."""
    s = f.s
    zero = torch.zeros_like(f.r)
    g_den = g_srat / s.den
    if s.plane:
        g_den1 = g_den * s.qf
        g_qf = g_den * s.den1
        g_qp = _sel(s.cl, g_qf)
        g_qs = _sel(s.qsel & ~s.cl, g_qf)
    else:
        g_den1 = g_den
    g_pout = g_den1 * _wmax(s.pout, s.pout.new_tensor(SIL_P_FLOOR))
    g_we = g_pout * s.ve
    g_ve = g_pout * s.we
    g_blk = -g_pout
    g_mw = _sel(s.fb, g_blk * s.mv)
    g_mv = _sel(s.fb, g_blk * s.mw)
    g_we = g_we + g_mw * _wmin(s.we, s.wb)
    g_wb = g_mw * _wmin(s.wb, s.we)
    g_ve = g_ve + g_mv * _wmin(s.ve, s.vb)
    g_vb = g_mv * _wmin(s.vb, s.ve)
    # Winner opacity and validity.
    g_xr = _clip_adj(_sig_adj(_sel(s.wm, g_we), s.w, s.ew), s.xm, s.xr)
    g_disc = g_xr / s.sw1
    g_sw = ((-g_xr) * f.disc) * (1.0 / (s.sw1 * s.sw1))
    g_vr = _clip_adj(_sig_adj(_sel(s.wm, g_ve), s.v, s.ev), s.vm, s.vr)
    g_traw = g_vr / s.v1
    # Blocker opacity and validity.
    g_xbr = _clip_adj(_sig_adj(_sel(s.fb, g_wb), s.mb, s.eb), s.xbm, s.xbr)
    g_discb = g_xbr / s.sb1
    g_sb = ((-g_xbr) * s.discb) * (1.0 / (s.sb1 * s.sb1))
    g_vbr = _clip_adj(_sig_adj(_sel(s.fb, g_vb), s.vbv, s.evb), s.vbm, s.vbr)
    g_trb = g_vbr / s.vb1
    g_tcb = g_trb
    g_sqb = torch.where(s.use_nb, -g_trb, g_trb)
    g_dmaxb = g_sqb * (0.5 / s.sqb)
    g_t, g_sxw, g_sxb, g_pk = zero, zero, zero, zero
    g_o, g_d = [zero, zero, zero], [zero, zero, zero]
    if s.plane:
        # Crossing loser: q_p = sigmoid(clip((t_bx - t) / sigma_x(r_b))).
        g_qpr = _clip_adj(_sig_adj(g_qp, s.qp, s.eqp), s.qpm, s.qpr)
        g_qpn = g_qpr / s.sxb1
        g_sxb = ((-g_qpr) * s.qpn) * (1.0 / (s.sxb1 * s.sxb1))
        g_t = g_t - g_qpn
        g_trbx = g_qpn * _wmax(s.t_raw_bx, s.t_raw_bx.new_tensor(t_min))
        g_tcb = g_tcb + g_trbx
        g_inb = torch.where(s.use_nbx, -g_trbx, g_trbx) * (0.5 / s.cappedb)
        g_sb = g_sb + g_inb
        g_dmaxb = g_dmaxb + g_inb
        # Sphere winner: q_s = sigmoid(clip((t_pl - t) / sigma_x(r))).
        g_qsr = _clip_adj(_sig_adj(g_qs, s.qs, s.eqs), s.qsm, s.qsr)
        g_qsn = g_qsr / s.sxw1
        g_sxw = ((-g_qsr) * s.qsn) * (1.0 / (s.sxw1 * s.sxw1))
        g_t = g_t - g_qsn
        # t_pl = (-(o . n) - k) / (d . n); n is not a parameter.
        g_num4 = g_qsn / s.den4s
        g_den4 = _sel(s.live4, ((-g_qsn) * s.num4) * (1.0 / (s.den4s * s.den4s)))
        g_pk = -g_num4
        g_o = [(-g_num4) * s.pn[c] for c in range(3)]
        g_d = [g_den4 * s.pn[c] for c in range(3)]
    g_discb = g_discb + g_dmaxb * _wmax(s.discb, s.discb.new_tensor(_DISC_EPS))
    g_br = (2.0 * (g_discb * s.br) + _scale_adj(g_sb, s.br, f.soft)
            + _xscale_adj(g_sxb, s.br, f.soft))
    g_tcb = g_tcb + 2.0 * (g_discb * s.tcb)
    g_bc = []
    for c in range(3):
        g_ocb = 2.0 * ((-g_discb) * s.ocb[c]) + g_tcb * f.d[c]
        g_d[c] = g_d[c] + g_tcb * s.ocb[c]
        g_o[c] = g_o[c] - g_ocb
        g_bc.append(g_ocb)
    return SimpleNamespace(disc=g_disc, traw=g_traw, t=g_t, sw=g_sw, sxw=g_sxw,
                           o=g_o, d=g_d, blk4=(*g_bc, g_br), pk=g_pk)


class BounceCotangents(NamedTuple):
    """Cotangents of one bounce's inputs (tuples of [N] tensors; the sky's
    per lane).  ``blk4`` (the blocker's cx, cy, cz, r) and ``pk`` (the
    plane offset, per lane) are zero without soft silhouettes; ``e3`` (the
    winner's emission) is empty without ``emission``."""

    o: tuple
    d: tuple
    tp: tuple
    a9: tuple
    sky: tuple
    blk4: tuple
    pk: torch.Tensor
    e3: tuple = ()


def bounce_tile_adjoint(o3, d3, tp3, a9, mat, hit, alive, u, sky6, do_rr,
                        ct_o3, ct_d3, ct_tp3, ct_rad3, *, t_min: float,
                        t_max: float, rr_on: bool, plane_mask=None,
                        softness: float = 0.0, blocker=None, plane4=None,
                        cross_loser=None, fresnel: bool = False,
                        emission=None) -> BounceCotangents:
    """Hand-written reverse pass of ``bounce_tile``: the cotangents of
    (o3, d3, tp3, a9, sky6) and, under soft silhouettes, of the blocker's
    attributes and the plane offset, and with ``emission`` of the winner's
    emission, from those of (o'3, d'3, tp'3, rad3).  Sky cotangents come
    back per lane ([N] each; the caller sums them), and so do the
    emission's.  Dead lanes (``alive`` False) pass the carried cotangents
    through."""
    f, _ = _forward(o3, d3, tp3, a9, mat, hit, alive, u, sky6, do_rr,
                    t_min, t_max, rr_on, plane_mask, softness, blocker,
                    plane4, cross_loser, fresnel, emission)
    zero = torch.zeros_like(f.r)

    # Russian roulette: nt2 = boost ? nt / q : nt, q = clip(max3(nt)).
    g_nt = list(ct_tp3)
    if rr_on:
        g_q = zero
        for c in range(3):
            g_q = g_q + _sel(f.boost, (-g_nt[c] * f.nt[c]) * (1.0 / (f.qq * f.qq)))
            g_nt[c] = torch.where(f.boost, g_nt[c] / f.qq, g_nt[c])
        g_q1 = g_q * _wmin(f.q1, f.q1.new_tensor(1.0))
        g_m2 = g_q1 * _wmax(f.m2, f.m2.new_tensor(0.05))
        g_m1 = g_m2 * _wmax(f.m1, f.nt[2])
        g_nt[2] = g_nt[2] + g_m2 * _wmax(f.nt[2], f.m1)
        g_nt[0] = g_nt[0] + g_m1 * _wmax(f.nt[0], f.nt[1])
        g_nt[1] = g_nt[1] + g_m1 * _wmax(f.nt[1], f.nt[0])

    # Throughput, attenuation, radiance, sky.
    g_tp, g_at, g_sk = [], [], []
    for c in range(3):
        gt = torch.where(f.surv0, g_nt[c] * f.at[c], g_nt[c])
        if emission is None:
            g_tp.append(gt + _sel(f.miss, ct_rad3[c] * f.sk[c]))
        else:
            # The emission term's suffix: a lit hit adds ct_rad * e.
            g_e = torch.where(f.lit, ct_rad3[c] * emission[c], zero)
            g_tp.append(gt + torch.where(f.miss, ct_rad3[c] * f.sk[c], g_e))
        g_at.append(_sel(f.surv0, g_nt[c] * f.tp[c]))
        g_sk.append(_sel(f.miss, ct_rad3[c] * f.tp[c]))
    g_sky = [None] * 6
    for c in range(3):
        g_w = g_sk[c] * f.s01
        g_sky[c + 3] = g_w
        g_sky[c] = g_sk[c] - g_w
    g_s01 = g_sk[0] * f.skw[0] + g_sk[1] * f.skw[1] + g_sk[2] * f.skw[2]

    sa = None
    if softness:
        # tp enters scaled by den / stop_grad(den) == 1: g_tp above is the
        # scaled throughput's cotangent, and the ratio's is g_tp . tp.
        g_srat = g_tp[0] * f.tp[0] + g_tp[1] * f.tp[1] + g_tp[2] * f.tp[2]
        sa = _soft_adjoint(f, g_srat, t_min)

    g_o = [torch.where(f.live, zero, ct_o3[c]) for c in range(3)]
    g_d = [torch.where(f.surv0, zero, ct_d3[c]) for c in range(3)]
    g_d[1] = g_d[1] + 0.5 * g_s01
    g_sd = [_sel(f.surv0, ct_d3[c]) for c in range(3)]
    g_p = [_sel(f.live, ct_o3[c]) for c in range(3)]
    g_alb = [torch.where(f.is_diel, zero, g_at[c]) for c in range(3)]

    # Scatter: one branch per lane.
    is_lam = ~f.is_metal & ~f.is_diel
    nf, d = f.nf, f.d
    g_nf = [zero, zero, zero]
    g_rf = [zero, zero, zero]
    g_dnf = zero
    g_fz = zero
    g_io = zero

    # Lambertian.
    g_l = [g_sd[c] * f.linv for c in range(3)]
    g_ln2 = _rsqrt_adj(_dot(g_sd, f.l), f.linv, f.lm, f.ln2, 1e-20)
    g_l = [g_l[c] + 2.0 * (g_ln2 * f.l[c]) for c in range(3)]
    for c in range(3):
        g_nf[c] = g_nf[c] + _sel(is_lam, torch.where(f.ldeg, g_sd[c], g_l[c]))

    # Metal.
    g_m = [g_sd[c] * f.minv for c in range(3)]
    g_mn2 = _rsqrt_adj(_dot(g_sd, f.m), f.minv, f.mm, f.mn2, 1e-20)
    g_m = [g_m[c] + 2.0 * (g_mn2 * f.m[c]) for c in range(3)]
    met_sm = f.is_metal & ~f.mdeg
    g_bs = (g_m[0] * f.cm + g_m[1] * f.sm) * f.rm + g_m[2] * f.zm
    g_fz = g_fz + _sel(met_sm, g_bs * f.bs0)
    for c in range(3):
        g_nf[c] = g_nf[c] + _sel(f.is_metal & f.mdeg, g_sd[c])
        g_rf[c] = g_rf[c] + _sel(met_sm, g_m[c])

    # Dielectric.
    g_g = [g_sd[c] * f.ginv for c in range(3)]
    g_gn2 = _rsqrt_adj(_dot(g_sd, f.g), f.ginv, f.gm, f.gn2, 1e-20)
    g_g = [g_g[c] + 2.0 * (g_gn2 * f.g[c]) for c in range(3)]
    die_sm = f.is_diel & ~f.gdeg
    refl = die_sm & f.do_refl
    refr = die_sm & ~f.do_refl
    g_par = -_dot(g_g, nf)
    g_px = g_par * (0.5 / f.par) * _wmax(f.px, f.px.new_tensor(1e-12))
    g_pp = [g_g[c] + 2.0 * ((-g_px) * f.pp[c]) for c in range(3)]
    g_eta = _dot(g_pp, f.inner)
    g_in = [g_pp[c] * f.eta for c in range(3)]
    g_cos = _dot(g_in, nf)
    g_dnf = g_dnf + _sel(refr, -(g_cos * _wmin(-f.dnf, f.dnf.new_tensor(1.0))))
    g_io = g_io + _sel(refr, torch.where(
        f.front, (-g_eta) * (1.0 / (f.io * f.io)), g_eta))
    for c in range(3):
        g_nf[c] = g_nf[c] + _sel(f.is_diel & f.gdeg, g_sd[c])
        g_rf[c] = g_rf[c] + _sel(refl, g_g[c])
        g_nf[c] = g_nf[c] + _sel(refr, -(g_g[c] * f.par) + g_in[c] * f.cos_t)
        g_d[c] = g_d[c] + _sel(refr, g_in[c])
    if f.fresnel:
        # The Schlick-coin ratio on every dielectric hit (its three channels
        # share it).
        g_cos, g_eta = _fresnel_adjoint(f, (g_at[0] + g_at[1]) + g_at[2])
        g_dnf = g_dnf + _sel(f.is_diel, -(g_cos * _wmin(-f.dnf, f.dnf.new_tensor(1.0))))
        g_io = g_io + _sel(f.is_diel, torch.where(
            f.front, (-g_eta) * (1.0 / (f.io * f.io)), g_eta))

    # Mirror direction rf = d - two_dn * nf, two_dn = 2 (d . nf).
    g_two_dn = -_dot(g_rf, nf)
    g_dnf = g_dnf + 2.0 * g_two_dn
    for c in range(3):
        g_d[c] = g_d[c] + g_rf[c]
        g_nf[c] = g_nf[c] - g_rf[c] * f.two_dn
    for c in range(3):
        g_d[c] = g_d[c] + g_dnf * nf[c]
        g_nf[c] = g_nf[c] + g_dnf * d[c]
    g_n = [g_nf[c] * f.fsign for c in range(3)]

    # Normal: face-forward plane normal on plane lanes, else normalized
    # (p - c) / r.
    sph = ~f.pm if f.pm is not None else torch.ones_like(f.live)
    g_c = [zero, zero, zero]
    g_r = zero
    if f.pm is not None:
        g_c = [g_c[c] + _sel(f.pm, f.psgn * g_n[c]) for c in range(3)]
    g_n0 = [g_n[c] * f.ninv for c in range(3)]
    g_ninv = _dot(g_n, f.n0)
    g_sn = (-g_ninv) * (1.0 / (f.sn * f.sn))
    g_nn = g_sn * (0.5 / f.sn)
    g_n0 = [g_n0[c] + 2.0 * (g_nn * f.n0[c]) for c in range(3)]
    g_q = [g_n0[c] / f.r for c in range(3)]
    g_rn = zero
    for c in range(3):
        g_rn = g_rn + (-g_n0[c] * f.q[c]) * (1.0 / (f.r * f.r))
    g_r = g_r + _sel(sph, g_rn)
    for c in range(3):
        g_p[c] = g_p[c] + _sel(sph, g_q[c])
        g_c[c] = g_c[c] - _sel(sph, g_q[c])

    # Hit point p = o + t d.
    g_t = _dot(g_p, d)
    if sa is not None:
        g_t = g_t + sa.t
    for c in range(3):
        g_o[c] = g_o[c] + g_p[c]
        g_d[c] = g_d[c] + g_p[c] * f.t

    if f.pm is not None:
        # t = (-(o . n) - k) / den, den = d . n (n detached by the caller).
        g_num = g_t / f.den_s
        g_den = _sel(f.live_d, ((-g_t) * f.num) * (1.0 / (f.den_s * f.den_s)))
        for c in range(3):
            g_d[c] = g_d[c] + _sel(f.pm, g_den * f.c[c])
            g_c[c] = g_c[c] + _sel(f.pm, g_den * d[c])
            g_o[c] = g_o[c] + _sel(f.pm, (-g_num) * f.c[c])
            g_c[c] = g_c[c] + _sel(f.pm, (-g_num) * f.o[c])
        g_r = g_r + _sel(f.pm, -g_num)

    # Sphere t from the winner: t = near ? tc - sq : tc + sq (soft: clamped
    # to t_min, and the sqrt's derivative capped).
    sh = sph & hit
    g_traw = g_t
    if sa is not None:
        g_traw = g_t * _wmax(f.t_raw, f.t_raw.new_tensor(t_min)) + sa.traw
    g_sq = torch.where(f.use_near, -g_traw, g_traw)
    if sa is not None:
        g_in = g_sq * (0.5 / f.capped)
        g_disc = g_in * _wmax(f.disc, f.disc.new_tensor(_DISC_EPS)) + sa.disc
        g_r = g_r + _sel(sh, _scale_adj(g_in + sa.sw, f.r, softness)
                         + _xscale_adj(sa.sxw, f.r, softness))
    else:
        g_disc = g_sq * (0.5 / f.sq) * _wmax(f.disc, f.disc.new_tensor(_DISC_EPS))
    g_tc = g_traw + 2.0 * (g_disc * f.tc)
    g_r = g_r + _sel(sh, 2.0 * (g_disc * f.r))
    for c in range(3):
        g_oc = 2.0 * ((-g_disc) * f.oc[c]) + g_tc * d[c]
        g_d[c] = g_d[c] + _sel(sh, g_tc * f.oc[c])
        g_c[c] = g_c[c] + _sel(sh, g_oc)
        g_o[c] = g_o[c] - _sel(sh, g_oc)

    g_blk4, g_pk = (zero,) * 4, zero
    if sa is not None:
        for c in range(3):
            g_o[c] = g_o[c] + sa.o[c]
            g_d[c] = g_d[c] + sa.d[c]
        g_blk4, g_pk = sa.blk4, sa.pk

    # Dead lanes: identity on the carried cotangents.
    al = alive
    g_o = [torch.where(al, g_o[c], ct_o3[c]) for c in range(3)]
    g_d = [torch.where(al, g_d[c], ct_d3[c]) for c in range(3)]
    g_tp = [torch.where(al, g_tp[c], ct_tp3[c]) for c in range(3)]
    g_a9 = [_sel(al, x) for x in (*g_c, g_r, *g_alb, g_fz, g_io)]
    g_sky = [_sel(al, x) for x in g_sky]
    g_e3 = ()
    if emission is not None:
        g_e3 = tuple(_sel(f.lit, ct_rad3[c] * f.tp[c]) for c in range(3))
    return BounceCotangents(
        tuple(g_o), tuple(g_d), tuple(g_tp), tuple(g_a9), tuple(g_sky),
        tuple(_sel(al, x) for x in g_blk4), _sel(al, g_pk), g_e3,
    )
