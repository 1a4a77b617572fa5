"""The port's soft-silhouette bounce (``ops/bounce.py``, ``softness > 0``)
against the JAX package's ``bounce_tile`` and the port's hand-written
adjoint.

Random (8, 128) tiles from ``test_torch_grad_bounce.make_tile``, flattened,
get a blocker per lane (a sphere placed across the ray before the winner,
or none), the acceptance coin ``u[7]`` and the validity coin ``uv``; grazing
winners put the opacity sigmoids inside their band.  The cases cover the
ties that are the normal case here: solid winner and solid blocker both
saturate ``sigmoid(30)`` to 1.0, so ``min(We, Wb)`` and ``min(Ve, Vb)`` tie
1 against 1 and the realized probability sits on the ``SIL_P_FLOOR``
floor.  Plane tiles add the crossing factor: sphere-win lanes with an
in-band plane hit, and plane lanes whose blocker is the crossing loser.
The JAX package tells the two blocker roles apart by replaying the coins;
the port takes the role as an input (its forward records it), so the test
hands the port the role JAX's replay gives.

Bounds as in ``test_torch_grad_bounce.py``: values 1e-6 relative;
cotangents rtol 1e-4 with an atol of 1e-6 times the lane's largest
cotangent (at least 1), plus two terms for the rounding of what a
cotangent cancels, which its final size does not show:
* a crossing loser's log q_p has derivatives ~1 / sigma_x(r_b)^2 that
  cancel in its radius cotangent: 10 times the float32 autograd's own
  distance from the float64 autograd of the same function;
* under Russian roulette the ratio's cotangent sum_c g_tp[c] tp[c] cancels
  (the boost 1/q makes the next throughput independent of the scale of
  tp), terms as large as the lane's cotangents without roulette (same
  tile, same output cotangents), some 30 of them, each rounded at ~6e-8 of
  its size: 1e-5 times the lane's largest cotangent of that run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_grad_bounce import N, T_MAX, T_MIN, make_tile

from simplepathtracer_tpu.ops import intersect as j_intersect
from simplepathtracer_tpu.ops.pallas_common import silhouette_logit_tile
from simplepathtracer_tpu.ops.pallas_grad import bounce_tile as j_bounce_tile
from simplepathtracer_tpu_torch.ops.bounce import bounce_tile, bounce_tile_adjoint

SOFT = 0.05
PLANE_N = np.array([0.1, 1.0, -0.2], np.float32) / np.linalg.norm([0.1, 1.0, -0.2])
PLANE_K = np.float32(0.5)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_soft_tile(seed, plane):
    t = make_tile(seed, plane)
    rng = np.random.default_rng(100 + seed)
    f32 = np.float32
    o, d, a9 = t["o"].T.astype(np.float64), t["d"].T.astype(np.float64), t["a9"]
    c, r = a9[:3].T.astype(np.float64), np.abs(a9[3]).astype(np.float64)
    pm = t["pm"] if plane else np.zeros(N, bool)
    # Grazing winners on a third of the sphere lanes: aim at the silhouette.
    graze = (rng.random(N) < 0.35) & t["hit"] & ~pm
    perp = _unit(np.cross(d, rng.normal(size=(N, 3))))
    tc = np.sum((c - o) * d, -1)
    dist = r * rng.uniform(0.97, 1.03, N)
    aim = o + d * tc[:, None] + perp * dist[:, None]
    graze &= tc > 3 * r
    d[graze] = _unit(aim[graze] - o[graze])
    if plane:
        # Crossings: move a quarter of the other sphere winners onto the
        # plane where the ray meets it, so the sphere leads the plane by
        # less than the crossing band.
        den = d @ PLANE_N
        t_pl = -(o @ PLANE_N + PLANE_K) / np.where(np.abs(den) > 1e-8, den, 1.0)
        cross = (t["hit"] & ~pm & ~graze & (t_pl > 1.0) & (t_pl < 20.0)
                 & (rng.random(N) < 0.5))
        c[cross] = (o + d * t_pl[:, None] + perp * (0.6 * r)[:, None])[cross]
        a9[:3, cross] = c[cross].T
        tc = np.sum((c - o) * d, -1)
    # Blockers: a sphere across the ray at a fraction of the winner's
    # distance, at the edge of the ray or solidly on it.
    t_w = np.where(t["hit"], np.maximum(tc, 0.5), 4.0)
    frac = rng.uniform(0.2, 0.8, N)
    br = rng.uniform(0.1, 0.4, N)
    off = br * np.where(rng.random(N) < 0.5, rng.uniform(0.9, 1.1, N), rng.uniform(0.0, 0.6, N))
    bc = o + d * (t_w * frac)[:, None] + _unit(np.cross(d, rng.normal(size=(N, 3)))) * off[:, None]
    bval = rng.random(N) < 0.75
    bc[~bval] = 0.0
    br[~bval] = 0.0
    if plane:
        # Plane lanes: some blockers sit on the plane hit point (crossing
        # losers when the replayed coins accept them).
        den = d @ PLANE_N
        tp = -(o @ PLANE_N + PLANE_K) / np.where(np.abs(den) > 1e-8, den, 1.0)
        on = pm & bval & (rng.random(N) < 0.6)
        hitp = o + d * tp[:, None]
        bc[on] = hitp[on] + _unit(rng.normal(size=(on.sum(), 3))) * br[on, None] * 0.5
    t["d"] = d.T.astype(f32).copy()
    t["blk"] = np.stack([bc[:, 0], bc[:, 1], bc[:, 2], br]).astype(f32)
    t["bval"] = bval
    u = t["u"]
    u[7] = np.where(rng.random(N) < 0.5, u[7] * 0.3, u[7]).astype(f32)
    t["uv"] = (np.floor(rng.random(N) * 2**24) * 2.0**-24).astype(f32)
    t["cts"] = rng.normal(size=(12, N)).astype(f32)
    return t


def _jax_role(t):
    """The crossing-loser role JAX's bounce_tile replays from the coins."""
    bcx, bcy, bcz, br = (jnp.asarray(x) for x in t["blk"])
    o = [jnp.asarray(x) for x in t["o"]]
    d = [jnp.asarray(x) for x in t["d"]]
    ocb = (bcx - o[0], bcy - o[1], bcz - o[2])
    tcb = ocb[0] * d[0] + ocb[1] * d[1] + ocb[2] * d[2]
    discb = br * br - ((ocb[0] * ocb[0] + ocb[1] * ocb[1] + ocb[2] * ocb[2]) - tcb * tcb)
    sqb = jnp.sqrt(jnp.maximum(discb, 1e-12))
    tnb = tcb - sqb
    t_raw_b = jnp.where(tnb > T_MIN, tnb, tcb + sqb)
    acc = discb > silhouette_logit_tile(jnp.asarray(t["u"][7])) * j_intersect.silhouette_scale(SOFT, br)
    valc = t_raw_b > T_MIN + silhouette_logit_tile(jnp.asarray(t["uv"])) * (
        j_intersect.validity_scale(SOFT, br))
    return np.asarray(acc & valc) & t["bval"]


def _torch_args(t, requires_grad=False, dtype=torch.float32):
    def tt(x):
        x = torch.tensor(x)
        if x.is_floating_point():
            x = x.to(dtype)
        return x.requires_grad_(requires_grad) if x.is_floating_point() else x

    groups = dict(
        o=tuple(tt(x) for x in t["o"]), d=tuple(tt(x) for x in t["d"]),
        tp=tuple(tt(x) for x in t["tp"]), a9=tuple(tt(x) for x in t["a9"]),
        sky=tuple(tt(np.full(N, s, np.float32)) for s in t["sky"]),
        blk=tuple(tt(x) for x in t["blk"]),
    )
    if t["pm"] is not None:
        groups["pk"] = (tt(np.full(N, PLANE_K, np.float32)),)
    fixed = dict(mat=torch.tensor(t["mat"]), hit=torch.tensor(t["hit"]),
                 alive=torch.tensor(t["alive"]),
                 u=tuple(torch.tensor(x).to(dtype) for x in t["u"]),
                 do_rr=torch.tensor(t["do_rr"]))
    return groups, fixed


def _soft_kw(t, groups):
    kw = dict(softness=SOFT, blocker=(torch.tensor(t["bval"]), *groups["blk"]))
    if t["pm"] is not None:
        kw.update(plane_mask=torch.tensor(t["pm"]),
                  plane4=(*(float(x) for x in PLANE_N), groups["pk"][0]),
                  cross_loser=torch.tensor(t["role"]))
    return kw


def _jax_vjp(t, rr_on):
    sh = (8, 128)

    def j(x):
        return jnp.asarray(np.asarray(x).reshape(sh))

    plane = t["pm"] is not None
    pm = j(t["pm"]) if plane else None
    smask = j(np.where(t["pm"], 0.0, 1.0).astype(np.float32)) if plane else jnp.ones(sh)
    args = [tuple(j(x) for x in t[k]) for k in ("o", "d", "tp", "a9")]
    args.append(tuple(jnp.full(sh, s) for s in t["sky"]))
    args.append(tuple(j(x) for x in t["blk"]))
    if plane:
        args.append(jnp.full(sh, PLANE_K))

    def f(o3, d3, tp3, a9, sky6, blk4, pk=None):
        return j_bounce_tile(
            o3, d3, tp3, a9, j(t["mat"]), j(t["hit"]), j(t["alive"]),
            tuple(j(x) for x in t["u"]), sky6, j(t["do_rr"]), t_min=T_MIN, t_max=T_MAX,
            rr_on=rr_on, silhouette=(smask, SOFT), plane_mask=pm,
            blocker=(j(t["bval"]), *blk4),
            plane4=(*(jnp.full(sh, x) for x in PLANE_N), pk) if plane else None,
            uv=j(t["uv"]),
        )

    full = f(*args)
    _, pull = jax.vjp(lambda *a: f(*a)[:4], *args)
    cts = tuple(tuple(j(t["cts"][3 * i + c]) for c in range(3)) for i in range(4))
    g = pull(cts)
    flat = lambda xs: np.stack([np.asarray(x).reshape(-1) for x in xs])  # noqa: E731
    vals = np.concatenate([flat(x) for x in full[:4]] + [np.asarray(full[4]).reshape(1, -1)])
    grads = [flat(x) for x in g[:6]]
    if plane:
        grads.append(np.asarray(g[6]).reshape(1, -1))
    return vals, grads


def _torch_autograd(t, rr_on, dtype=torch.float32):
    groups, fx = _torch_args(t, requires_grad=True, dtype=dtype)
    out = bounce_tile(groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"],
                      fx["hit"], fx["alive"], fx["u"], groups["sky"], fx["do_rr"],
                      t_min=T_MIN, t_max=T_MAX, rr_on=rr_on, **_soft_kw(t, groups))
    vals = np.concatenate([torch.stack(x).detach().numpy() for x in out[:4]]
                          + [out[4].detach().numpy()[None]])
    cts = torch.tensor(t["cts"]).to(dtype)
    loss = sum((torch.stack(out[i]) * cts[3 * i:3 * i + 3]).sum() for i in range(4))
    ins = list(groups.values())
    gs = torch.autograd.grad(loss, [x for grp in ins for x in grp], allow_unused=True)
    gs = [torch.zeros(N, dtype=dtype) if g is None else g for g in gs]
    grads, k = [], 0
    for grp in ins:
        grads.append(torch.stack(gs[k:k + len(grp)]).to(torch.float32).numpy())
        k += len(grp)
    return vals, grads


def _adjoint(t, rr_on):
    groups, fx = _torch_args(t)
    cts = torch.tensor(t["cts"])
    ct = [tuple(cts[3 * i + c] for c in range(3)) for i in range(4)]
    g = bounce_tile_adjoint(groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"],
                            fx["hit"], fx["alive"], fx["u"], groups["sky"], fx["do_rr"], *ct,
                            t_min=T_MIN, t_max=T_MAX, rr_on=rr_on, **_soft_kw(t, groups))
    out = [torch.stack(x).numpy() for x in (g.o, g.d, g.tp, g.a9, g.sky, g.blk4)]
    if t["pm"] is not None:
        out.append(g.pk.numpy()[None])
    return out


CASES = [(10, False, False), (11, False, True), (12, True, False), (13, True, True)]
IDS = ["spheres", "spheres-rr", "plane", "plane-rr"]
NAMES = ("o", "d", "tp", "a9", "sky6", "blocker4", "plane_offset")


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    seed, plane, rr_on = request.param
    t = make_soft_tile(seed, plane)
    if plane:
        # JAX's roles: an accepted blocker is the crossing loser on a plane
        # lane and no blocker at all elsewhere (the port's forward records
        # no such blocker).
        role = _jax_role(t)
        t["bval"] = t["bval"] & ~(role & ~t["pm"])
        t["role"] = role & t["pm"]
    tv, tg = _torch_autograd(t, rr_on)
    _, tg64 = _torch_autograd(t, rr_on, torch.float64)
    rr_scale = np.zeros(N, np.float32)
    if rr_on:
        rr_scale = np.max([np.abs(g).max(axis=0) for g in _torch_autograd(t, False)[1]], axis=0)
    t["extra"] = [10.0 * np.abs(a - b) + 1e-5 * rr_scale for a, b in zip(tg, tg64)]
    return t, rr_on, _jax_vjp(t, rr_on), (tv, tg)


def assert_soft_close(got, want, name, extra):
    scale = np.maximum(1.0, np.abs(want).max(axis=0))
    bad = np.abs(got - want) > 1e-4 * np.abs(want) + 1e-6 * scale + extra
    assert not bad.any(), (name, np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


def _probabilities(t):
    """Per-lane soft intermediates of the port's forward (for coverage)."""
    from simplepathtracer_tpu_torch.ops.bounce import _forward

    groups, fx = _torch_args(t)
    f, _ = _forward(groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"], fx["hit"],
                    fx["alive"], fx["u"], groups["sky"], fx["do_rr"], T_MIN, T_MAX, False,
                    None if t["pm"] is None else torch.tensor(t["pm"]),
                    **{k: v for k, v in _soft_kw(t, groups).items() if k != "plane_mask"})
    return f.s


def test_soft_tiles_cover_the_cases(case):
    t, _, _, _ = case
    s = _probabilities(t)
    live = torch.tensor(t["alive"])
    band = (s.xr.abs() < 30) & s.wm
    assert band.sum() > 50                                   # winner opacity in its band
    assert (s.fb & live).sum() > 50                          # front blockers
    assert (s.pout < 1e-2).sum() > 20                        # on the floor
    if t["pm"] is None:
        # Solid blockers (the plane tiles keep rejected blockers only).
        tie = s.fb & (s.we == s.wb) & (s.ve == s.vb)
        assert tie.sum() > 20                                # min ties 1 against 1
    else:
        assert (s.cl & live).sum() > 20                      # crossing losers
        assert (s.qsel & (s.qsr.abs() < 30)).sum() > 20      # in-band sphere crossings


def test_soft_bounce_values_match_jax(case):
    _, _, (jv, _), (tv, _) = case
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def test_soft_bounce_autograd_matches_jax_vjp(case):
    t, _, (_, jg), (_, tg) = case
    assert len(jg) == len(tg)
    for name, a, b, e in zip(NAMES, jg, tg, t["extra"]):
        assert_soft_close(b, a, name, e)


def test_soft_adjoint_matches_autograd(case):
    t, rr_on, _, (_, tg) = case
    ag = _adjoint(t, rr_on)
    assert len(ag) == len(tg)
    for name, a, b, e in zip(NAMES, tg, ag, t["extra"]):
        assert_soft_close(b, a, name, e)
