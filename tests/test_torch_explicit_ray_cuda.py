"""The bounce-step and closest-hit kernels (``csrc/bounce_step.cu``,
``csrc/closest_hit.cu``) against their plain versions on the card.  They
are CUDA kernels with no CPU mode, so these tests skip without an NVIDIA
GPU; ``chip_smoke.py`` phase 9 holds the same comparisons at the main
paths' shapes.  This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_explicit_ray_cuda.py -m cuda

Every output must be bit-exact: the kernels round every operation as their
plain versions do (``--fmad=false``, IEEE sqrt and division).  The hits
route's gradient runs the bucket kernel, whose atomics add in an order
that changes from run to run: its gradients are held to rtol 1e-5.
"""

import pytest
import torch
from kernel_cases import AXIS_SPHERES, grazing_rays

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.camera import generate_rays
from simplepathtracer_tpu_torch.ops import bounce_step as bs
from simplepathtracer_tpu_torch.ops import bucket
from simplepathtracer_tpu_torch.ops import closest_hit as ch
from simplepathtracer_tpu_torch.ops.sampling import camera_jitter, ray_keys
from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs
from simplepathtracer_tpu_torch.ops.table_gather import attach_attr_columns, gather_rows
from simplepathtracer_tpu_torch.render import bounce_step_call


def _case(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if name == "cover":
        scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
        cam = tpt.PRESETS["cover"].camera_fn("cuda")
        w, h, spp, rr = 64, 32, 4, 0
    else:
        scene = tpt.three_sphere_scene(hollow_glass=True, device="cuda")
        if name == "three_sphere_plane":
            scene = tpt.with_ground_plane(scene)
        cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device="cuda")
        w, h, spp, rr = 48, 24, 8, 2
    p = w * h
    keys = ray_keys(tpt.make_key(1), torch.arange(p, device="cuda").repeat(spp),
                    torch.arange(spp, device="cuda").repeat_interleave(p))
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=10, rr_start_depth=rr,
                           use_pallas=True)
    o, d = generate_rays(cam, w, h, keys.pixel, camera_jitter(keys))
    return scene, cam, cfg, keys, o, d


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["three_sphere", "three_sphere_plane", "cover"])
def test_explicit_ray_kernels_match_plain_on_card(name):
    """Each bounce of the bounce-step kernel, and on each bounce's rays the
    two closest-hit kernels, bit for bit against their plain versions."""
    scene, cam, cfg, keys, o, d = _case(name)
    call = bounce_step_call(scene, keys, cfg)
    tables = tuple(t.contiguous() for t in scene_inputs(scene)[:11])
    state = bs.initial_state(o, d)
    pix, samp = keys.pixel.int().contiguous(), keys.sample.int().contiguous()
    before = tracing.counts()
    for b in range(cfg.max_depth):
        nxt = bs.bounce_step(call, state, pix, samp, b)
        torch.cuda.synchronize()
        assert torch.equal(nxt, bs.bounce_step_reference(call, state, pix, samp, b)), b
        ro, rd, alive = state[0:3].T.contiguous(), state[3:6].T.contiguous(), state[12] > 0
        got = ch.closest_hit_attrs(ro, rd, alive, tables)
        want = ch.closest_hit_attrs_reference(ro, rd, alive, tables)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), b
        assert all(torch.equal(a, w) for a, w in zip(got[1], want[1])), b
        got = ch.closest_hit(ro, rd, alive, scene.centers, scene.radii)
        want = ch.closest_hit_reference(ro, rd, alive, scene.centers, scene.radii)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), b
        state = nxt
    ran = tracing.counts() - before
    assert (ran["launch.bounce_step"], ran["launch.closest_hit_attrs"],
            ran["launch.closest_hit"]) == (cfg.max_depth,) * 3
    assert torch.isfinite(state).all() and state[9:12].max() > 0


@pytest.mark.cuda
def test_hits_pixel_loss_kernels_match_plain_on_card(monkeypatch):
    """pixel_loss through the hits route: through the kernels, and through
    the plain versions on the same card tensors (loss bit-equal, gradients
    to the bucket's atomics)."""
    scene, cam, cfg, *_ = _case("three_sphere")
    cfg = cfg.replace(use_pallas=False, use_pallas_hits=True, spp=2, max_depth=6)
    target = torch.full((cfg.height, cfg.width, 3), 0.25, device="cuda")

    def loss_grads():
        params, static = tpt.split_params(scene)
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = tpt.pixel_loss(params, static, target, cam, cfg, tpt.make_key(3), device="cuda")
        return loss, torch.autograd.grad(loss, list(params.values()))

    before = tracing.counts()
    l_k, g_k = loss_grads()
    # One bucket per bounce but the last, whose attributes reach no output.
    assert (tracing.counts() - before)["launch.bucket.9"] == cfg.max_depth - 1
    monkeypatch.setattr(ch, "closest_hit_attrs", ch.closest_hit_attrs_reference)
    monkeypatch.setattr(bucket, "bucket_cols", bucket.bucket_cols_reference)
    l_p, g_p = loss_grads()
    assert torch.equal(l_k, l_p)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "all", "one_in_33", "queue_fills", "random"])
@pytest.mark.parametrize("name", ["three_sphere", "cover"])
def test_closest_hit_attrs_compaction_on_card(name, pattern):
    """The attributes kernel runs a group of 32 rays with at least 24 live
    in place; a sparser group's live rays join the warp's queue, which runs
    32 at a time, and the rays still queued after the warp's last group run
    one per lane.  Bit for bit against the plain version, through the
    wrapper with and without a prebuilt table, on every pattern of live
    rays: none, all, one in 33 (at most one per group of 32), 20 of every 32
    (below the in-place threshold: the queue fills on most groups and a
    partial tail is left), and half at random.  The rays are the case's
    camera rays repeated, cut to a count that is not a multiple of 32: 2 M
    on three_sphere, so each warp of the resident grid walks several
    groups, and 327 K on cover (488 sphere slots)."""
    scene, cam, cfg, keys, o, d = _case(name)
    tables = tuple(t.contiguous() for t in scene_inputs(scene)[:11])
    reps = -(-2_000_003 // o.shape[0]) if name == "three_sphere" else 40
    n = o.shape[0] * reps - 5
    o, d = o.repeat(reps, 1)[:n].contiguous(), d.repeat(reps, 1)[:n].contiguous()
    i = torch.arange(n, device="cuda")
    alive = {"none": i < 0, "all": i >= 0, "one_in_33": i % 33 == 0,
             "queue_fills": i % 32 < 20,
             "random": torch.rand(n, generator=torch.Generator("cuda").manual_seed(2),
                                  device="cuda") < 0.5}[pattern]
    before = tracing.counts()
    got = ch.closest_hit_attrs(o, d, alive, tables)
    want = ch.closest_hit_attrs_reference(o, d, alive, tables)
    again = ch.closest_hit_attrs(o, d, alive, tables, tab=ch.sphere_table(tables))
    assert (tracing.counts() - before)["launch.closest_hit_attrs"] == 2
    for out in (got, again):
        assert torch.equal(out[0], want[0]) and torch.equal(out[2], want[2])
        assert all(torch.equal(a, w) for a, w in zip(out[1], want[1]))
    assert (got[0][~alive] == -1).all()
    if pattern != "none":
        assert (got[0][alive] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "all", "one_in_33", "queue_fills", "random"])
@pytest.mark.parametrize("name", ["three_sphere", "three_sphere_plane", "cover"])
def test_bounce_step_compaction_on_card(name, pattern):
    """The bounce-step kernel runs a group of 32 rays with at least 24 live
    in place (dead and live rays storing in the same instructions); a
    sparser group's dead rays copy their state at once and its live rays
    join the warp's queue, which runs 32 at a time, and the rays still
    queued after the warp's last group run one per lane.  Bit for bit
    against the plain version -- every live ray's next state and every
    dead ray's copy -- on every pattern of live rays: none, all, one in 33,
    20 of every 32 (the queue fills on most groups and a partial tail is
    left) and half at random, at bounce 0 and at bounce 3 (Russian roulette
    on where the case sets it from bounce 2).  The rays are the case's
    camera rays repeated, cut to a count that is not a multiple of 32: 2 M
    on the three-sphere scenes, so each warp of the resident grid walks
    several groups, and 327 K on cover (488 sphere slots)."""
    scene, cam, cfg, keys, o, d = _case(name)
    call = bounce_step_call(scene, keys, cfg)
    reps = 40 if name == "cover" else -(-2_000_003 // o.shape[0])
    n = o.shape[0] * reps - 5
    o, d = o.repeat(reps, 1)[:n].contiguous(), d.repeat(reps, 1)[:n].contiguous()
    pix = keys.pixel.int().repeat(reps)[:n].contiguous()
    samp = keys.sample.int().repeat(reps)[:n].contiguous()
    i = torch.arange(n, device="cuda")
    alive = {"none": i < 0, "all": i >= 0, "one_in_33": i % 33 == 0,
             "queue_fills": i % 32 < 20,
             "random": torch.rand(n, generator=torch.Generator("cuda").manual_seed(2),
                                  device="cuda") < 0.5}[pattern]
    state = bs.initial_state(o, d)
    state[12] = alive.float()
    before = tracing.counts()
    for b in (0, 3):
        got = bs.bounce_step(call, state, pix, samp, b)
        torch.cuda.synchronize()
        assert torch.equal(got, bs.bounce_step_reference(call, state, pix, samp, b)), b
        assert torch.equal(got[:12, ~alive], state[:12, ~alive]) and not got[12, ~alive].any()
        if pattern != "none":
            assert got[12, alive].any() and not torch.equal(got[:, alive], state[:, alive])
    assert (tracing.counts() - before)["launch.bounce_step"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("alive_mask", ["all", "some", "none"])
@pytest.mark.parametrize("spheres", ["axis", "cover"])
def test_closest_hit_grazing_rays_on_card(spheres, alive_mask):
    """The index-and-t kernel bit for bit against its plain version on
    ``kernel_cases.grazing_rays``: tangent rays (disc exactly 0 on spheres
    centered on the z axis), rays an ulp off, rays from inside, near roots
    at t_min, with every, some and no ray alive.  The kernel takes the roots only where
    disc > 0; the plain version keeps the JAX kernel's sqrt(max(disc, 0))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if spheres == "axis":
        centers, radii = (torch.tensor(a, device="cuda") for a in AXIS_SPHERES)
    else:
        scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
        centers, radii = scene.centers, scene.radii
    o, d = grazing_rays(centers, radii)
    n = o.shape[0]
    alive = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
             "some": torch.arange(n, device="cuda") % 3 != 0,
             "none": torch.zeros(n, dtype=torch.bool, device="cuda")}[alive_mask]
    before = tracing.counts()
    idx, t = ch.closest_hit(o, d, alive, centers, radii)
    assert (tracing.counts() - before)["launch.closest_hit"] == 1
    want_idx, want_t = ch.closest_hit_reference(o, d, alive, centers, radii)
    assert torch.equal(idx, want_idx) and torch.equal(t, want_t)
    assert alive_mask == "none" or bool((idx >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("s,k", [(37, 3), (5000, 9)], ids=["K3", "S5000"])
def test_gather_rows_takes_any_table_shape_on_card(s, k):
    """``gather_rows`` on the card takes tables the bucket kernel does not
    (K = 3; S = 5000 > 4096): value equal to the plain gather's, gradient
    to plain autograd's to rtol 1e-5, and no bucket launch; on the same
    rows ``attach_attr_columns`` (the hits route's 9 columns) still
    launches the bucket kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator().manual_seed(3)
    n = 3000
    table = torch.randn((s, k), generator=gen).cuda().requires_grad_(True)
    idx = torch.randint(0, s, (n,), generator=gen, dtype=torch.int32).cuda()
    ct = torch.randn((n, k), generator=gen).cuda()
    before = tracing.counts()
    out = gather_rows(table, idx)
    assert torch.equal(out, table[idx.long()])
    (g,) = torch.autograd.grad(out, [table], ct)
    (g_plain,) = torch.autograd.grad(table[idx.long()], [table], ct)
    torch.testing.assert_close(g, g_plain, rtol=1e-5, atol=1e-5)
    assert not [k for k in tracing.counts() - before if k.startswith("launch.bucket.")]
    if s <= 4096:
        tab9 = torch.randn((s, 9), generator=gen).cuda().requires_grad_(True)
        cols = tuple(tab9.detach()[idx.long(), j] for j in range(9))
        before = tracing.counts()
        out9 = attach_attr_columns(tab9, idx, *cols)
        (g9,) = torch.autograd.grad(sum(c.sum() for c in out9), [tab9])
        assert (tracing.counts() - before)["launch.bucket.9"] == 1
        torch.testing.assert_close(g9, torch.autograd.grad(tab9[idx.long()].sum(), [tab9])[0],
                                   rtol=1e-5, atol=1e-5)
