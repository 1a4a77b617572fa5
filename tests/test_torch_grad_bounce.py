"""The port's differentiable bounce (ops/bounce.py) against the JAX
package's ``bounce_tile`` and its own hand-written adjoint.

Random (8, 128) tiles, flattened, made from a seed with numpy, cover
Lambertian, metal and glass winners (total internal reflection and a
negative radius included), plane lanes, Russian roulette on and off, miss
and dead lanes, and the ties where JAX's gradient rules differ from
torch's defaults: grey throughput (max over tied channels), ``tp == 1``
after glass (the clip's upper bound) and a head-on hit (``cos_t == 1``).

Bounds: values 1e-6 relative (the same ops in the same order; cos, sin,
exp and log may differ by an ulp between XLA and PyTorch); cotangents
rtol 1e-4, atol 1e-6 (sums taken in another order).  A lane whose
cotangents reach a magnitude m > 1 (a roulette boost 1/q up to 20) cancels
terms of that size, whose f32 rounding alone is ~m * 6e-8 per term, so its
atol is 1e-6 * m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from simplepathtracer_tpu.ops.pallas_grad import bounce_tile as j_bounce_tile
from simplepathtracer_tpu_torch.ops.bounce import bounce_tile, bounce_tile_adjoint

N = 8 * 128
T_MIN, T_MAX = 1e-3, 3.0e7


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_tile(seed, plane):
    """Inputs of one bounce for N lanes, as float32 / bool / int numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = rng.uniform(-3, 3, (N, 3)).astype(f32)
    rad = rng.uniform(0.3, 1.5, N).astype(f32)
    rad = np.where(rng.random(N) < 0.15, -rad, rad).astype(f32)   # hollow glass
    inside = rng.random(N) < 0.2
    # Origins outside (distance 2..6 radii) or inside the sphere.
    dist = np.where(inside, rng.uniform(0.1, 0.8, N), rng.uniform(2, 6, N)) * np.abs(rad)
    o = (c + _unit(rng.normal(size=(N, 3))) * dist[:, None]).astype(f32)
    # Aim at a point on the sphere (hits), or anywhere from inside.
    tgt = c + _unit(rng.normal(size=(N, 3))) * np.abs(rad)[:, None] * 0.7
    d = _unit(np.where(inside[:, None], rng.normal(size=(N, 3)), tgt - o)).astype(f32)
    mat = rng.integers(0, 3, N).astype(np.int32)
    mat = np.where(inside, 2, mat).astype(np.int32)                # TIR candidates
    alb = rng.uniform(0.05, 0.95, (N, 3)).astype(f32)
    fz = rng.uniform(0, 0.5, N).astype(f32)
    io = rng.uniform(1.3, 1.7, N).astype(f32)
    tp = rng.uniform(0.02, 1.5, (N, 3)).astype(f32)
    hit = np.ones(N, bool)
    alive = rng.random(N) > 0.1
    # Miss lanes: scan defaults (r = 1, ior = 1, the rest 0).
    miss = rng.random(N) < 0.12
    hit[miss] = False
    c[miss] = 0.0
    rad[miss] = 1.0
    alb[miss] = 0.0
    fz[miss] = 0.0
    io[miss] = 1.0
    mat[miss] = 0
    # Ties: grey throughput on grey Lambertian, tp == 1 on glass, head-on.
    grey = np.arange(N) % 16 == 1
    tp[grey] = tp[grey, :1]
    alb[grey] = alb[grey, :1]
    mat[grey] = 0
    ones = np.arange(N) % 16 == 2
    tp[ones] = 1.0
    mat[ones] = 2
    head = np.arange(N) % 16 == 3
    c[head] = (0.0, 0.0, 0.0)
    rad[head] = 1.0
    o[head] = (0.0, 0.0, -5.0)
    d[head] = (0.0, 0.0, 1.0)
    mat[head] = 2
    tp[head] = 1.0
    pm = np.zeros(N, bool)
    if plane:
        pm = (np.arange(N) % 5 == 4) & ~miss
        n = _unit(np.array([0.1, 1.0, -0.2], f32)).astype(f32)
        k = f32(0.5)
        c[pm] = n
        rad[pm] = k
        alb[pm] = (0.9, 0.8, 0.7)
        fz[pm] = 0.0
        io[pm] = 1.0
        mat[pm] = 0
        # Origins above the plane, rays going down through it.
        o[pm] = rng.uniform(-2, 2, (pm.sum(), 3)).astype(f32) + 2.0 * n
        dd = _unit(rng.normal(size=(pm.sum(), 3)))
        dd = dd - 1.2 * np.abs(dd @ n)[:, None] * n
        d[pm] = _unit(dd)
    u = np.floor(rng.random((8, N)) * 2**24).astype(f32) * f32(2.0**-24)
    sky = rng.uniform(0.1, 1.0, 6).astype(f32)
    do_rr = rng.random(N) < 0.7
    a9 = np.stack([c[:, 0], c[:, 1], c[:, 2], rad, alb[:, 0], alb[:, 1], alb[:, 2], fz, io])
    cts = rng.normal(size=(12, N)).astype(f32)
    return dict(o=o.T.copy(), d=d.T.copy(), tp=tp.T.copy(), a9=a9.astype(f32), mat=mat,
                hit=hit, alive=alive, u=u, sky=sky, do_rr=do_rr,
                pm=pm if plane else None, cts=cts)


CASES = [(0, False, False), (1, False, True), (2, True, False), (3, True, True)]
IDS = ["spheres", "spheres-rr", "plane", "plane-rr"]


def _torch_args(t, requires_grad=False):
    def tt(x):
        x = torch.tensor(x)
        return x.requires_grad_(requires_grad) if x.is_floating_point() else x

    o3 = tuple(tt(x) for x in t["o"])
    d3 = tuple(tt(x) for x in t["d"])
    tp3 = tuple(tt(x) for x in t["tp"])
    a9 = tuple(tt(x) for x in t["a9"])
    sky6 = tuple(tt(np.full(N, s, np.float32)) for s in t["sky"])
    fixed = dict(mat=torch.tensor(t["mat"]), hit=torch.tensor(t["hit"]),
                 alive=torch.tensor(t["alive"]),
                 u=tuple(torch.tensor(x) for x in t["u"]), do_rr=torch.tensor(t["do_rr"]))
    pm = None if t["pm"] is None else torch.tensor(t["pm"])
    return o3, d3, tp3, a9, sky6, fixed, pm


def _jax_vjp(t, rr_on):
    sh = (8, 128)

    def j(x):
        return jnp.asarray(np.asarray(x).reshape(sh))

    o3 = tuple(j(x) for x in t["o"])
    d3 = tuple(j(x) for x in t["d"])
    tp3 = tuple(j(x) for x in t["tp"])
    a9 = tuple(j(x) for x in t["a9"])
    sky6 = tuple(jnp.full(sh, s) for s in t["sky"])
    u = tuple(j(x) for x in t["u"])
    pm = None if t["pm"] is None else j(t["pm"])

    def f(o3, d3, tp3, a9, sky6):
        return j_bounce_tile(
            o3, d3, tp3, a9, j(t["mat"]), j(t["hit"]), j(t["alive"]), u, sky6,
            j(t["do_rr"]), t_min=T_MIN, t_max=T_MAX, rr_on=rr_on, plane_mask=pm,
        )

    out, pull = jax.vjp(lambda *a: f(*a)[:4], o3, d3, tp3, a9, sky6)
    full = f(o3, d3, tp3, a9, sky6)
    cts = tuple(tuple(j(t["cts"][3 * i + c]) for c in range(3)) for i in range(4))
    g = pull(cts)
    flat = lambda xs: np.stack([np.asarray(x).reshape(-1) for x in xs])  # noqa: E731
    vals = np.concatenate([flat(x) for x in full[:4]] + [np.asarray(full[4]).reshape(1, -1)])
    grads = [flat(x) for x in g]
    return vals, grads


def _torch_autograd(t, rr_on):
    o3, d3, tp3, a9, sky6, fx, pm = _torch_args(t, requires_grad=True)
    out = bounce_tile(o3, d3, tp3, a9, fx["mat"], fx["hit"], fx["alive"], fx["u"], sky6,
                      fx["do_rr"], t_min=T_MIN, t_max=T_MAX, rr_on=rr_on, plane_mask=pm)
    vals = np.concatenate([torch.stack(x).detach().numpy() for x in out[:4]]
                          + [out[4].detach().numpy()[None]])
    cts = torch.tensor(t["cts"])
    loss = sum((torch.stack(out[i]) * cts[3 * i:3 * i + 3]).sum() for i in range(4))
    ins = (o3, d3, tp3, a9, sky6)
    gs = torch.autograd.grad(loss, [x for grp in ins for x in grp], allow_unused=True)
    gs = [torch.zeros(N) if g is None else g for g in gs]
    grads, k = [], 0
    for grp in ins:
        grads.append(torch.stack(gs[k:k + len(grp)]).numpy())
        k += len(grp)
    return vals, grads


def _adjoint(t, rr_on):
    o3, d3, tp3, a9, sky6, fx, pm = _torch_args(t)
    cts = torch.tensor(t["cts"])
    ct = [tuple(cts[3 * i + c] for c in range(3)) for i in range(4)]
    g = bounce_tile_adjoint(o3, d3, tp3, a9, fx["mat"], fx["hit"], fx["alive"], fx["u"],
                            sky6, fx["do_rr"], *ct, t_min=T_MIN, t_max=T_MAX, rr_on=rr_on,
                            plane_mask=pm)
    return [torch.stack(x).numpy() for x in g[:5]]


NAMES = ("o", "d", "tp", "a9", "sky6")


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    seed, plane, rr_on = request.param
    t = make_tile(seed, plane)
    return t, rr_on, _jax_vjp(t, rr_on), _torch_autograd(t, rr_on)


def test_tiles_cover_the_cases(case):
    t, rr_on, _, _ = case
    mat, hit, alive = t["mat"], t["hit"], t["alive"]
    for m in range(3):
        assert ((mat == m) & hit & alive).sum() > 20
    assert (~hit & alive).sum() > 20 and (~alive).sum() > 20
    assert (t["a9"][3] < 0).sum() > 20
    if t["pm"] is not None:
        assert t["pm"].sum() > 100


def test_bounce_values_match_jax(case):
    _, _, (jv, _), (tv, _) = case
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def assert_cotangents_close(got, want, name):
    """|got - want| <= 1e-4 |want| + 1e-6 max(1, m_lane), m_lane the
    largest |cotangent| of the lane in this group (module docstring)."""
    scale = np.maximum(1.0, np.abs(want).max(axis=0, keepdims=True))
    bad = np.abs(got - want) > 1e-4 * np.abs(want) + 1e-6 * scale
    assert not bad.any(), (name, np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


def test_bounce_autograd_matches_jax_vjp(case):
    _, _, (_, jg), (_, tg) = case
    for name, a, b in zip(NAMES, jg, tg):
        assert_cotangents_close(b, a, name)


def test_adjoint_matches_autograd(case):
    t, rr_on, _, (_, tg) = case
    ag = _adjoint(t, rr_on)
    for name, a, b in zip(NAMES, tg, ag):
        assert_cotangents_close(b, a, name)
