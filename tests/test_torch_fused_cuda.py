"""The per-bounce fused gradient kernels (``csrc/grad.cu``) against their
plain versions on the card.  They are CUDA kernels with no CPU mode, so
these tests skip without an NVIDIA GPU; ``chip_smoke.py`` phase 8 holds the
same comparisons at the main path's shapes.  The forward's and the
backward's live-ray compaction are held on live patterns that stress it.  This file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_fused_cuda.py -m cuda

Raygen, every forward output and the backward's per-ray cotangents must be
bit-exact.  The backward's sky cotangents and the buckets sum with atomics
in an order that changes from run to run: they are held against a float64
sum of the same terms, to rtol 1e-5 plus 8 float32 roundings of the terms'
absolute sum (``chip_smoke.py``'s bucket bound).
"""

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import bucket, grad as fg
from simplepathtracer_tpu_torch.ops.bounce import bounce_tile_adjoint
from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs
from simplepathtracer_tpu_torch.ops.sampling import ray_keys

F32_EPS = 2.0 ** -23


def _case(name, spp):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if name == "cover":
        scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
        cam = tpt.PRESETS["cover"].camera_fn("cuda")
        w, h = 64, 32
    else:
        scene = tpt.three_sphere_scene(device="cuda")
        cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cuda")
        w, h = 48, 24
    p = w * h
    pids = torch.arange(p, device="cuda").repeat(spp)
    sids = torch.arange(spp, device="cuda").repeat_interleave(p)
    return scene, cam, w, h, ray_keys(tpt.make_key(4), pids, sids)


def _within_sum_bound(got, terms):
    """got ([K]) against the float64 sum over the last axis of terms ([K, R])."""
    ref = terms.double().sum(dim=-1)
    tol = 1e-5 * ref.abs() + 8 * F32_EPS * terms.double().abs().sum(dim=-1) + 1e-30
    return bool(((got.double() - ref).abs() <= tol).all())


def _sky_terms(call, state, idx, bidx, pix, samp, bounce, carry, ct_rad):
    """The sky's 6 cotangents per ray, [6, N]: the terms the backward sums
    (``bounce_tile_adjoint`` on the plain version's inputs)."""
    o, d, tp, alive, u = fg._bounce_inputs(call, state, pix, samp, bounce)
    i64 = idx.to(torch.int64)
    a9, mat = fg._winner(call, i64)
    g = bounce_tile_adjoint(
        o, d, tp, a9, mat, i64 >= 0, alive, u, tuple(call.consts[i] for i in range(6)),
        bounce >= call.rr_start_depth, tuple(carry[0:3]), tuple(carry[3:6]),
        tuple(carry[6:9]), tuple(ct_rad), t_min=call.t_min, t_max=call.t_max,
        rr_on=bool(call.rr_start_depth), **fg._bounce_kwargs(call, bidx))
    return torch.stack(g.sky)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,spp,depth,rr,softness",
    [("cover", 2, 10, 0, 0.0), ("cover", 2, 10, 0, 0.05), ("three_sphere", 4, 6, 2, 0.0),
     ("three_sphere", 4, 6, 2, 0.05)],
    ids=["cover", "cover-soft", "trio-rr", "trio-soft-rr"],
)
def test_fused_kernels_match_plain_on_card(name, spp, depth, rr, softness):
    scene, cam, w, h, keys = _case(name, spp)
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr,
                           silhouette_softness=softness)
    before = tracing.counts()
    rays = fg.raygen(cam, keys, cfg)
    assert (tracing.counts() - before)["launch.raygen"] == 1
    assert torch.equal(rays, fg.raygen_reference(cam, keys, cfg))

    inputs = scene_inputs(scene)
    call = fg.fused_call(inputs[:11], inputs[11], keys.k0, keys.k1, max_depth=depth,
                         rr_start_depth=rr, softness=softness)
    soft = softness > 0.0
    n = rays.shape[1]
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    state = torch.cat([rays, torch.ones((4, n), device="cuda")]).contiguous()
    rad = torch.zeros((3, n), device="cuda")
    prev = torch.full((n,), -1, dtype=torch.int32, device="cuda") if soft else None
    saved = []
    for b in range(depth):
        rad_p = rad.clone()
        got = fg.grad_forward(call, state, rad, prev, pix, samp, b)
        want = fg.grad_fwd_reference(call, state, rad_p, prev, pix, samp, b)
        for g, x in zip(got, want):
            assert (g is None) == (x is None) and (g is None or torch.equal(g, x)), b
        assert torch.equal(rad, rad_p)
        saved.append((state, got[2], got[3]))
        state, prev = got[0], got[1]
    assert (rad > 0).any() and torch.isfinite(rad).all()

    gen = torch.Generator().manual_seed(5)
    ct_rad = torch.randn((3, n), generator=gen).to("cuda")
    carry = torch.zeros((9, n), device="cuda")
    for b in range(depth - 1, -1, -1):
        st, idx, bidx = saved[b]
        ck, ak, sk = fg.grad_backward(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
        cp, ap, _ = fg.grad_bwd_reference(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
        assert torch.equal(ck, cp) and torch.equal(ak, ap), b
        sp = _sky_terms(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
        assert _within_sum_bound(sk, sp), (b, sk, sp.sum(dim=1))
        cols = [(ak[:9], idx)] + ([(ak[9:], bidx)] if soft else [])
        s = call.n_spheres
        for c, ix in cols:
            d = bucket.bucket_cols(c, ix, s)
            keep = ix >= 0
            onehot = torch.zeros((s, c.shape[1]), dtype=torch.float64, device="cuda")
            onehot[ix[keep].long(), torch.nonzero(keep)[:, 0]] = 1.0
            terms = onehot[:, None, :] * c.double()[None, :, :]
            assert _within_sum_bound(d, terms), b
        carry = ck
    assert torch.isfinite(carry).all() and carry[:6].abs().max() > 0


def _alive_pattern(pattern, n):
    """The alive plane of a compaction case: every ray, none, one ray in
    each group of 32 (a warp's group), or every 33rd ray."""
    alive = torch.zeros(n, device="cuda")
    if pattern == "all":
        alive[:] = 1.0
    elif pattern == "one_per_group":
        alive[17::32] = 1.0
    elif pattern == "every33":
        alive[::33] = 1.0
    return alive


@pytest.mark.cuda
@pytest.mark.parametrize("softness", [0.0, 0.05], ids=["hard", "soft"])
@pytest.mark.parametrize("pattern", ["all", "dead", "one_per_group", "every33"])
def test_fused_forward_compaction_on_card(pattern, softness):
    """The forward queues a warp's live rays and scans them 32 at a time:
    on live patterns that leave few, scattered or no live rays, over a
    batch that is not a multiple of a warp's group or a block (61 x 29 x 3
    = 5,307 rays), three chained bounces (soft: the previous-winner chain)
    are bit-exact against the plain version, skip values included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
    cam = tpt.PRESETS["cover"].camera_fn("cuda")
    w, h, spp, depth = 61, 29, 3, 3
    p = w * h
    pids = torch.arange(p, device="cuda").repeat(spp)
    sids = torch.arange(spp, device="cuda").repeat_interleave(p)
    keys = ray_keys(tpt.make_key(6), pids, sids)
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, silhouette_softness=softness)
    rays = fg.raygen(cam, keys, cfg)
    n = rays.shape[1]
    assert n % 32 and n % 128
    inputs = scene_inputs(scene)
    call = fg.fused_call(inputs[:11], inputs[11], keys.k0, keys.k1, max_depth=depth,
                         softness=softness)
    soft = softness > 0.0
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    alive = _alive_pattern(pattern, n)
    state = torch.cat([rays, torch.ones((3, n), device="cuda"), alive[None]]).contiguous()
    rad = torch.zeros((3, n), device="cuda")
    prev = torch.full((n,), -1, dtype=torch.int32, device="cuda") if soft else None
    variant = "soft" if soft else "hard"
    for b in range(depth):
        rad_p = rad.clone()
        before = tracing.counts()
        got = fg.grad_forward(call, state, rad, prev, pix, samp, b)
        assert (tracing.counts() - before)[f"launch.grad_forward.{variant}"] == 1
        want = fg.grad_fwd_reference(call, state, rad_p, prev, pix, samp, b)
        for g, x in zip(got, want):
            assert (g is None) == (x is None) and (g is None or torch.equal(g, x)), b
        assert torch.equal(rad, rad_p), b
        dead = state[9] <= 0
        assert torch.equal(got[0][:9, dead], state[:9, dead]) and (got[2][dead] == -1).all()
        state, prev = got[0], got[1]
    if pattern == "dead":
        assert not rad.any()
    else:
        assert (rad > 0).any() and torch.isfinite(rad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("softness", [0.0, 0.05], ids=["hard", "soft"])
@pytest.mark.parametrize("pattern", ["all", "dead", "one_per_group", "every33"])
def test_fused_backward_compaction_on_card(pattern, softness):
    """The backward passes a warp's dead rays through at once and runs the
    live rays' adjoints 32 at a time: on the forward's live patterns (5,307
    rays, three chained bounces traced by the kernel), every bounce's
    carried and attribute cotangents are bit-exact against the plain
    version, the dead rays' copies (ct_out = ct_in, attribute cotangents 0)
    included, with and without the attribute planes; the sky sums lie
    inside the float64 bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
    cam = tpt.PRESETS["cover"].camera_fn("cuda")
    w, h, spp, depth = 61, 29, 3, 3
    p = w * h
    pids = torch.arange(p, device="cuda").repeat(spp)
    sids = torch.arange(spp, device="cuda").repeat_interleave(p)
    keys = ray_keys(tpt.make_key(6), pids, sids)
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, silhouette_softness=softness)
    rays = fg.raygen(cam, keys, cfg)
    n = rays.shape[1]
    inputs = scene_inputs(scene)
    call = fg.fused_call(inputs[:11], inputs[11], keys.k0, keys.k1, max_depth=depth,
                         softness=softness)
    soft = softness > 0.0
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    state = torch.cat([rays, torch.ones((3, n), device="cuda"),
                       _alive_pattern(pattern, n)[None]]).contiguous()
    rad = torch.zeros((3, n), device="cuda")
    prev = torch.full((n,), -1, dtype=torch.int32, device="cuda") if soft else None
    saved = []
    for b in range(depth):
        nxt, prev, idx, bidx = fg.grad_forward(call, state, rad, prev, pix, samp, b)
        saved.append((state, idx, bidx))
        state = nxt
    gen = torch.Generator().manual_seed(8)
    ct_rad = torch.randn((3, n), generator=gen).to("cuda")
    carry = carry0 = torch.randn((9, n), generator=gen).to("cuda")
    variant = "soft" if soft else "hard"
    for b in range(depth - 1, -1, -1):
        st, idx, bidx = saved[b]
        dead = st[9] <= 0
        for want_attr in (True, False):
            before = tracing.counts()
            ck, ak, sk = fg.grad_backward(call, st, idx, bidx, pix, samp, b, carry, ct_rad,
                                          want_attr)
            assert (tracing.counts() - before)[f"launch.grad_backward.{variant}"] == 1
            cp, ap, _ = fg.grad_bwd_reference(call, st, idx, bidx, pix, samp, b, carry, ct_rad,
                                              want_attr)
            assert torch.equal(ck, cp) and torch.equal(ck[:, dead], carry[:, dead]), b
            assert (ak is None) == (not want_attr)
            if want_attr:
                assert torch.equal(ak, ap) and not ak[:, dead].any(), b
            sp = _sky_terms(call, st, idx, bidx, pix, samp, b, carry, ct_rad)
            assert _within_sum_bound(sk, sp), (b, sk, sp.sum(dim=1))
            assert pattern != "dead" or not sk.any()
        carry = ck
    assert torch.isfinite(carry).all()
    assert (pattern == "dead") == torch.equal(carry, carry0)


@pytest.mark.cuda
def test_fused_route_matches_regen_route_on_card():
    """On a sphere scene the fused route (raygen + per-bounce kernels)
    traces the regeneration route's paths: same rays, same bounce code.
    Only the order of the per-pixel sums differs, so the loss agrees to
    1e-6 and the gradients to rtol 2e-3, atol 2e-6 (the JAX package's
    regen bound)."""
    scene, cam, w, h, _ = _case("cover", 1)
    cfg = tpt.RenderConfig(width=w, height=h, spp=4, max_depth=10)
    target = torch.full((h, w, 3), 0.25, device="cuda")
    out = []
    for c in (cfg.replace(use_pallas_grad=True), cfg.replace(use_pallas_grad=True, grad_regen=True)):
        params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
        loss = tpt.pixel_loss(params, scene, target, cam, c, tpt.make_key(2), device="cuda")
        out.append((loss.item(), torch.autograd.grad(loss, list(params.values()))))
    (l_f, g_f), (l_r, g_r) = out
    assert abs(l_f - l_r) <= 1e-6 * abs(l_r)
    for a, b in zip(g_f, g_r):
        assert torch.allclose(a, b, rtol=2e-3, atol=2e-6)


# (name, width, height, pixel ids, sample ids) of the raygen edge cases.
_RAYGEN_EDGES = {
    # every pixel id of each frame size the repo renders (the divider's
    # width: 1200 and 400 the presets, 64 / 48 / 37 the tests)
    **{f"frame{w}x{h}": (w, h, "all", 1)
       for w, h in [(1200, 800), (400, 200), (64, 32), (48, 24), (37, 13)]},
    # 4,099 random ids of the 1200 x 800 frame: n % 4 != 0, the scalar path
    "tail4099": (1200, 800, "random", 4099),
    # the last 4,096 pixel ids of a 1200 x 800 frame, samples 0..7
    "last_pixels": (1200, 800, "last", 8),
    # a width that is not a power of two, ids up to 2^31 - 1
    "id_limit": (46337, 46345, "limit", 1),
}


def _raygen_edge(name):
    w, h, which, m = _RAYGEN_EDGES[name]
    dev = "cuda"
    if which == "all":
        pids = torch.arange(w * h, device=dev).repeat(m)
        sids = torch.arange(m, device=dev).repeat_interleave(w * h)
    elif which == "random":
        gen = torch.Generator().manual_seed(11)
        pids = torch.randint(0, w * h, (m,), generator=gen).to(dev)
        sids = torch.randint(0, 100, (m,), generator=gen).to(dev)
    elif which == "last":
        pids = torch.arange(w * h - 4096, w * h, device=dev).repeat(m)
        sids = torch.arange(m, device=dev).repeat_interleave(4096)
    else:
        pids = torch.arange(2**31 - 4096, 2**31, device=dev)
        sids = torch.zeros_like(pids)
    cfg = tpt.RenderConfig(width=w, height=h, spp=1)
    return cfg, ray_keys(tpt.make_key(12), pids, sids)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_RAYGEN_EDGES))
def test_raygen_edges_on_card(name):
    """Raygen bit for bit against its plain version where its host picks
    another path or its divider could slip: every pixel id of each frame
    size the repo renders, n % 4 != 0 (the scalar path), the last pixel ids
    of a 1200 x 800 frame, ids up to 2^31 - 1 at a width that is not a power
    of two; and the same ids as int32 one element off 16-byte alignment,
    which the kernel cannot load as int4 (the scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cam = tpt.PRESETS["cover"].camera_fn("cuda")
    cfg, keys = _raygen_edge(name)
    n = keys.pixel.shape[0]
    want = fg.raygen_reference(cam, keys, cfg)
    before = tracing.counts()
    assert torch.equal(fg.raygen(cam, keys, cfg), want)
    pix = torch.empty(n + 1, dtype=torch.int32, device="cuda")[1:]
    pix.copy_(keys.pixel)
    assert pix.data_ptr() % 16
    off = keys._replace(pixel=pix, sample=keys.sample.to(torch.int32))
    assert torch.equal(fg.raygen(cam, off, cfg), want)
    assert (tracing.counts() - before)["launch.raygen"] == 2
