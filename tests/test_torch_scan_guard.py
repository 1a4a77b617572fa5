"""The soft scan's exact skip (``csrc/common.cuh:closest_hit_soft``).

The kernels' soft scan walks the spheres in order and updates a winner
(bt, bi) and a blocker (qi, qs).  Sphere i can change neither when

    !(disc > lgt * scale_i) && !(disc / r_i^2 > qs)

-- the winner update needs the first test (acceptance), the blocker update
the second (its score beats the running best) -- so the kernels skip the
root, t and the thresholds there.  A NaN disc (padding slots: NaN radius)
fails both tests, as it fails every test of the full scan.  They also take
the root sqrt(max(disc, 1e-12)) as the constant sqrt(1e-12) where disc <=
1e-12 (a NaN disc too), and sqrt(disc) only above it.

This file checks the predicate's logic and the root's elision on a torch
mirror of the kernels' float32 arithmetic; it does not run ``common.cuh``.
The kernels themselves are held bit for bit against their plain versions
on the card (the ``cuda``-marked tests of ``test_torch_grad_cuda.py`` and
``test_torch_fused_cuda.py``, and ``chip_smoke.py``).

Here a sequential float32 scan with the kernels' arithmetic, vectorised
over rays, runs with the skip and the elided root and without either (the
clamped root, as before the skip) on the cover table (488 slots;
its dead padding slot given the kernels' NaN padding radius) with one
sphere duplicated into a later slot (exact ties in t and in score), over
seeded rays at bounce 0 (runs of 32 consecutive pixels, as a warp of the
regen forward takes them, plus rays aimed at the duplicated sphere) and
after a scatter off their hits (the chain's previous winner set), at
acceptance logits -30, 0, +30 and random, and over rays through two small
spheres where a rejected blocker with the larger score comes first
(random rays almost never need the acceptance test to keep a sphere whose
score does not beat qs; these do), and over rays grazing a sphere of radius
1e-4 whose disc lands in (0, 1e-12] (the constant root decides their t).
Bounds: (bt, bi, qi) identical with
and without the skip on every ray; against the plain
``ops/grad_regen.py:_scan_soft`` (one vectorised pass, running minimum as
an exclusive cumulative minimum) winner and blocker identical on every
ray: both evaluate the same float32 operations per (ray, sphere), so no
knife edge separates them.

    python tests/test_torch_scan_guard.py   # prints the skip's shares
"""

import numpy as np
import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import grad_regen as gr, intersect
from simplepathtracer_tpu_torch.ops.persistent import camera_ray_plain

SOFT = 0.02  # fit()'s default softness
W, H = 1200, 800
# The sphere copied into a later slot, and that slot.
TIE_SRC, TIE_DST = 5, 300
# The slot given a sphere of radius 1e-4 for the grazing rays, its centre
# (empty sky above the cover scene) and the rays' distance to that centre.
TINY, TINY_C, TINY_R, TINY_L = 400, (0.0, 5.0, 0.0), 1e-4, 1.5e-3
# The kernels' constant root, sqrtf(1e-12f).
SQ_MIN = torch.sqrt(torch.tensor(1e-12, dtype=torch.float32))


def _setup(tie=True, tiny=False):
    torch.set_num_threads(1)
    scene = tpt.compact_scene(tpt.cover_scene(0, device="cpu"))
    cam = tpt.PRESETS["cover"].camera_fn("cpu")
    cfg = tpt.RenderConfig(width=W, height=H, spp=1, max_depth=2, silhouette_softness=SOFT)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    tables = [t.detach().clone() for t in inputs[:11]]
    # The last slot is compact_scene's dead padding: give it the NaN radius
    # of the kernels' padding rows (cx cy cz r r^2 ...).
    tables[3][-1] = tables[4][-1] = float("nan")
    if tie:
        for t in tables:
            t[TIE_DST] = t[TIE_SRC]
    if tiny:
        for k in range(3):
            tables[k][TINY] = TINY_C[k]
        tables[3][TINY] = TINY_R
        tables[4][TINY] = tables[3][TINY] * tables[3][TINY]
    call = gr.regen_call(tables, inputs[11], None, cam19, tpt.make_key(3),
                         torch.arange(4), n_samples=1, max_depth=2, width=W, height=H,
                         softness=SOFT)
    return call, cam19


def scan_soft_seq(call, o, d, lgt, lgtv, prev, skip, legs=(True, True)):
    """closest_hit_soft over rays [N] in float32, one sphere at a time.
    ``skip``: rays for which the predicate holds keep their state (``legs``
    selects which of its two tests the predicate keeps), and the root is
    the kernels' (sqrt(disc) above 1e-12, else the constant); without it
    the root is sqrt(fmax(disc, 1e-12)) on every test.  Returns (bt, bi,
    qi, skipped [N, S] bool)."""
    tab, st = call.tab, call.soft_tab
    t_min, t_max = call.t_min, call.t_max
    n, s_pad = o[0].shape[0], tab.shape[0]
    f32 = torch.float32
    bt = torch.full((n,), t_max, dtype=f32)
    bi = torch.full((n,), -1, dtype=torch.int64)
    qi = torch.full((n,), -1, dtype=torch.int64)
    qs = torch.full((n,), float("-inf"), dtype=f32)
    skipped = torch.zeros((n, s_pad), dtype=torch.bool)
    for i in range(s_pad):
        g, s4 = tab[i], st[i]
        ocx, ocy, ocz = g[0] - o[0], g[1] - o[1], g[2] - o[2]
        tc = ocx * d[0] + ocy * d[1] + ocz * d[2]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        disc = g[3] * g[3] - (oc2 - tc * tc)
        score = disc * s4[1]
        in_band = disc > lgt * s4[0]
        beats = score > qs
        if skip:
            keep_a, keep_b = legs
            test = torch.zeros_like(in_band)
            if keep_a:
                test = test | in_band
            if keep_b:
                test = test | beats
            live = test
        else:
            live = torch.ones_like(in_band)
        skipped[:, i] = ~live
        if skip:
            sq = torch.where(disc > 1e-12, torch.sqrt(disc), SQ_MIN)
        else:
            sq = torch.sqrt(torch.fmax(disc, torch.tensor(1e-12, dtype=f32)))
        t_near = tc - sq
        t_raw = torch.where(t_near > t_min, t_near, tc + sq)
        t = torch.clamp(t_raw, min=t_min)
        is_prev = prev == i
        zero = torch.zeros_like(t)
        thr_v = torch.where(is_prev, zero, lgtv * s4[2])
        gate = torch.where(is_prev, zero, s4[3].expand_as(t))
        accept = in_band & (t_raw > t_min + thr_v) & (t_raw < t_max)
        in_front = t < bt
        blk = live & ~accept & (t_raw > t_min + gate) & in_front & beats
        win = live & accept & in_front
        qi = torch.where(blk, i, qi)
        qs = torch.where(blk, score, qs)
        bt = torch.where(win, t, bt)
        bi = torch.where(win, i, bi)
    return bt, bi, qi, skipped


def _rays(call, cam19, seed, n_groups, n_aimed):
    """Bounce-0 rays: ``n_groups`` runs of 32 consecutive pixels of the
    frame at random rows, then ``n_aimed`` rays from the camera toward the
    duplicated sphere's centre (jittered).  Returns (o, d) as 3-tuples."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, W * H - 32, n_groups)
    pix = torch.tensor((starts[:, None] + np.arange(32)[None, :]).reshape(-1), dtype=torch.int64)
    samp = torch.tensor(rng.integers(0, 64, pix.shape[0]), dtype=torch.int64)
    ray = camera_ray_plain(cam19, call.k0, call.k1, pix, samp, W, H)
    o, d = list(ray[:3]), list(ray[3:])
    if n_aimed:
        c = call.tab[TIE_SRC, :3].double().numpy()
        org = np.stack([x[:n_aimed].double().numpy() for x in o], 1)
        tgt = c[None, :] + rng.normal(0, 0.3, (n_aimed, 3))
        dirs = tgt - org
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        for k in range(3):
            o[k] = torch.cat([o[k], torch.tensor(org[:, k], dtype=torch.float32)])
            d[k] = torch.cat([d[k], torch.tensor(dirs[:, k], dtype=torch.float32)])
    return tuple(o), tuple(d)


def _scatter(call, o, d, bt, bi, seed):
    """Rays leaving the hit points of (o, d) in seeded random directions
    away from the winner's centre, with that winner as the previous one;
    rays that missed keep their ray and no previous winner."""
    rng = np.random.default_rng(seed)
    hit = bi >= 0
    n = o[0].shape[0]
    p = [torch.where(hit, oc + bt * dc, oc) for oc, dc in zip(o, d)]
    c = call.tab[bi.clamp(min=0), :3]
    nrm = torch.stack([p[k] - c[:, k] for k in range(3)], 1)
    nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp(min=1e-20)
    v = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    v = v / v.norm(dim=1, keepdim=True)
    v = torch.where(((v * nrm).sum(1) < 0)[:, None], -v, v)
    nd = [torch.where(hit, v[:, k], d[k]) for k in range(3)]
    return tuple(p), tuple(nd), torch.where(hit, bi, -1)


def _coins(n, lgt_case, seed):
    """(u7, uv): the acceptance coin at logit -30 / 0 / +30 (u = 1e-20, 0.5,
    1) or random, the validity coin random."""
    rng = np.random.default_rng(seed)
    fixed = {"-30": 1e-20, "0": 0.5, "+30": 1.0}
    if lgt_case == "random":
        u7 = rng.random(n)
    else:
        u7 = np.full(n, fixed[lgt_case])
    return (torch.tensor(u7, dtype=torch.float32),
            torch.tensor(rng.random(n), dtype=torch.float32))


def _bounces(call, cam19, seed, n_groups, n_aimed):
    """[(o, d, prev)] at bounce 0 and after a scatter."""
    o, d = _rays(call, cam19, seed, n_groups, n_aimed)
    n = o[0].shape[0]
    none = torch.full((n,), -1, dtype=torch.int64)
    u7, uv = _coins(n, "random", seed + 1)
    lg, lv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
    bt, bi, _, _ = scan_soft_seq(call, o, d, lg, lv, none, skip=False)
    o1, d1, prev1 = _scatter(call, o, d, bt, bi, seed + 2)
    return [(o, d, none), (o1, d1, prev1)]


@pytest.fixture(scope="module")
def bounces():
    call, cam19 = _setup()
    return call, _bounces(call, cam19, seed=11, n_groups=8, n_aimed=64)


@pytest.mark.parametrize("lgt_case", ["-30", "0", "+30", "random"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_soft_scan_skip_is_exact(bounces, bounce, lgt_case):
    call, rays = bounces
    o, d, prev = rays[bounce]
    n = o[0].shape[0]
    u7, uv = _coins(n, lgt_case, 100 + bounce)
    lgt, lgtv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
    full = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=False)
    fast = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=True)
    for a, b in zip(full[:3], fast[:3]):
        assert torch.equal(a, b)
    # The skip fires (on every padding slot at least) and the scan still
    # finds winners and blockers.
    assert fast[3][:, -1].all() and fast[3].any(dim=1).all()
    bi, qi = gr._scan_soft(call, o, d, u7, torch.zeros_like(u7), uv, prev)
    assert torch.equal(bi, fast[1]) and torch.equal(qi, fast[2])
    if lgt_case in ("-30", "random"):
        assert (fast[1] >= 0).any()
    if lgt_case in ("+30", "random"):
        assert (fast[2] >= 0).any()


def test_ties_resolve_to_the_first_slot(bounces):
    """The duplicated sphere: where the later copy would tie the first in
    t (accepted) or in score (blocker), the first slot wins, with and
    without the skip."""
    call, rays = bounces
    o, d, prev = rays[0]
    n = o[0].shape[0]
    for lgt_case, pick in (("-30", 1), ("+30", 2)):
        u7, uv = _coins(n, lgt_case, 7)
        lgt, lgtv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
        got = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=True)[pick]
        assert (got == TIE_SRC).any() and not (got == TIE_DST).any()


def _through_pairs(call, n_pairs, seed):
    """Rays through two small spheres a < b (slots) a few radii apart: the
    origin 0.03 in front of a's surface on the far side from b, aimed
    through a's centre at a point half b's radius off b's centre.  With
    the validity coin at +30 (threshold t_min + 0.06), a is rejected at t ~
    0.03 and becomes the blocker with score ~1; b, accepted behind it, has
    score ~0.75 < qs.  Returns (o, d, a, b)."""
    rng = np.random.default_rng(seed)
    tab = call.tab.double().numpy()
    c, r = tab[:, :3], tab[:, 3]
    small = np.flatnonzero((r > 0.1) & (r < 0.3))
    pairs = []
    for a in rng.permutation(small):
        near = [b for b in small if b > a and 1.0 < np.linalg.norm(c[b] - c[a]) < 2.5]
        if near:
            pairs.append((a, near[0]))
        if len(pairs) == n_pairs:
            break
    o, d = [], []
    for a, b in pairs:
        side = np.cross(c[b] - c[a], [0.0, 1.0, 0.0])
        tgt = c[b] + 0.5 * r[b] * side / np.linalg.norm(side)
        u = (tgt - c[a]) / np.linalg.norm(tgt - c[a])
        o.append(c[a] - (r[a] + 0.03) * u)
        d.append(u)
    o, d = np.array(o), np.array(d)
    to = lambda x: tuple(torch.tensor(x[:, k], dtype=torch.float32) for k in range(3))
    ab = torch.tensor(pairs, dtype=torch.int64)
    return to(o), to(d), ab[:, 0], ab[:, 1]


def test_skip_keeps_a_winner_behind_a_stronger_blocker():
    """Acceptance alone can pass a sphere whose score does not beat qs: the
    skip must keep it (its first test), or the winner behind a rejected
    high-score blocker is lost."""
    call, _ = _setup()
    o, d, a, b = _through_pairs(call, 48, seed=4)
    n = o[0].shape[0]
    u7, uv = torch.full((n,), 0.5), torch.ones(n)
    lgt, lgtv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
    prev = torch.full((n,), -1, dtype=torch.int64)
    full = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=False)
    fast = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=True)
    for x, y in zip(full[:3], fast[:3]):
        assert torch.equal(x, y)
    bi, qi = gr._scan_soft(call, o, d, u7, torch.zeros_like(u7), uv, prev)
    assert torch.equal(bi, fast[1]) and torch.equal(qi, fast[2])
    # Most rays: a is the blocker and b the winner.
    assert ((fast[2] == a) & (fast[1] == b)).float().mean() > 0.5


def _grazing(n, seed):
    """Rays from TINY_L off the tiny sphere's centre, aimed so that the
    centre lies at r * sqrt(1 - u) from the ray, u uniform in [-3e-4,
    3e-4]: disc ~ r^2 u spans (-3e-12, 3e-12) and float32 rounding.
    Returns (o, d) as 3-tuples of float32 and disc as the scan computes it."""
    rng = np.random.default_rng(seed)
    c = np.array(TINY_C)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    o = (c + TINY_L * w).astype(np.float32).astype(np.float64)
    v = o - c
    lv = np.linalg.norm(v, axis=1, keepdims=True)
    p = np.cross(v, rng.normal(size=(n, 3)))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    h2 = TINY_R**2 * (1.0 - rng.uniform(-3e-4, 3e-4, (n, 1)))
    dist = np.sqrt(h2 * lv**2 / (lv**2 - h2))
    d = c + dist * p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda x: tuple(torch.tensor(x[:, k], dtype=torch.float32) for k in range(3))
    o, d = to(o), to(d)
    cf = torch.tensor(TINY_C, dtype=torch.float32)
    ocx, ocy, ocz = cf[0] - o[0], cf[1] - o[1], cf[2] - o[2]
    tc = ocx * d[0] + ocy * d[1] + ocz * d[2]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r = torch.tensor(TINY_R, dtype=torch.float32)
    return o, d, r * r - (oc2 - tc * tc)


@pytest.mark.parametrize("lgt_case", ["-30", "random"])
def test_constant_root_on_grazing_rays(lgt_case):
    """Rays grazing a sphere of radius 1e-4 with disc in (0, 1e-12]: the
    kernels' constant root sqrt(1e-12) gives the t of the clamped root, and
    the sphere wins there (so a root sqrt(disc) would move bt)."""
    call, _ = _setup(tie=False, tiny=True)
    o, d, disc = _grazing(2048, seed=6)
    n = o[0].shape[0]
    small = (disc > 0) & (disc <= 1e-12)
    assert small.sum() >= 50 and (disc > 1e-12).sum() >= 50
    u7, uv = _coins(n, lgt_case, 21)
    if lgt_case == "-30":
        uv = torch.full_like(uv, 0.5)  # validity logit 0: t_raw > t_min decides
    lgt, lgtv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
    prev = torch.full((n,), -1, dtype=torch.int64)
    full = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=False)
    fast = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=True)
    for x, y in zip(full[:3], fast[:3]):
        assert torch.equal(x, y)
    bi, qi = gr._scan_soft(call, o, d, u7, torch.zeros_like(u7), uv, prev)
    assert torch.equal(bi, fast[1]) and torch.equal(qi, fast[2])
    won = small & (fast[1] == TINY)
    assert won.sum() >= 20
    if lgt_case == "-30":
        assert won.sum() == small.sum()


def skip_shares(seed=0, n_groups=128):
    """Share of the (ray, sphere) tests the skip takes, and of the (32
    consecutive rays, sphere) tests it takes for all 32, at bounce 0 and
    after a scatter, with random coins, on the unmodified cover table."""
    call, cam19 = _setup(tie=False)
    out = {}
    for b, (o, d, prev) in enumerate(_bounces(call, cam19, seed, n_groups, 0)):
        n = o[0].shape[0]
        u7, uv = _coins(n, "random", 50 + b)
        lgt, lgtv = intersect.silhouette_logit(u7), intersect.silhouette_logit(uv)
        skipped = scan_soft_seq(call, o, d, lgt, lgtv, prev, skip=True)[3]
        live = torch.isfinite(call.tab[:, 3])
        sk = skipped[:, live]
        warp = sk.view(-1, 32, sk.shape[1]).all(dim=1)
        out[f"bounce{b}"] = dict(rays=n, ray_sphere=sk.float().mean().item(),
                                 warp_sphere=warp.float().mean().item())
    return out


if __name__ == "__main__":
    print(skip_shares())
