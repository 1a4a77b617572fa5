"""The persistent kernel's plain version and the banked lane layout against
the JAX package's persistent kernel (interpret mode), sums and counts.

On the CPU ``render_block_persistent`` takes its plain version, written in
the kernel's formulation (direct |oc|^2), so it is compared with the JAX
Pallas kernel, which uses the same formulation.  The CUDA kernel itself is
held against the plain version on the card by the ``cuda``-marked tests
here (bit for bit, and run to run: its lanes fetch work items from a
counter)
and by chip_smoke.py.  They need no JAX:

    python -m pytest --noconftest tests/test_torch_persistent.py -m cuda
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import persistent
from simplepathtracer_tpu_torch.render import _persistent_args, _render_block_pallas

try:  # the card's machine has no JAX; the cuda-marked tests need none
    import jax
    import jax.numpy as jnp

    import simplepathtracer_tpu as spt
    from simplepathtracer_tpu.ops.pallas_common import banked_lane_layout
    from simplepathtracer_tpu.ops.pallas_persistent import DEFAULT_BANKS
    from simplepathtracer_tpu.render import _render_block_pallas as j_block
    from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene
except ImportError:
    pass


def _gamma(x, spp):
    return np.clip(np.asarray(x) / spp, 0.0, 1.0) ** 0.5


def _block_pair(jscene, jcam, w, h, spp, depth=10, rr=0, seed=1):
    kw = dict(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr, use_pallas=True)
    a, ca = j_block(
        jscene, jcam, spt.RenderConfig(**kw, pallas_interpret=True), jax.random.PRNGKey(seed),
        jnp.arange(w * h, dtype=jnp.int32), 0, spp, return_counts=True,
    )
    b, cb = _render_block_pallas(
        convert_scene(jscene, "cpu"), convert_camera(jcam, "cpu"), tpt.RenderConfig(**kw),
        tpt.make_key(seed), torch.arange(w * h), 0, spp, return_counts=True,
    )
    assert b.shape == (w * h, 3) and cb.shape == (w * h,)
    d = np.abs(_gamma(a, spp) - _gamma(b.numpy(), spp))
    flips = np.asarray(ca) != cb.numpy()
    return d, flips, cb.numpy()


_TRIO_CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)


def test_plane_scene_with_roulette_matches_jax_kernel():
    jscene = spt.with_ground_plane(spt.three_sphere_scene())
    d, flips, cnt = _block_pair(jscene, spt.make_camera(**_TRIO_CAM), 48, 24, 8, rr=2)
    assert d.mean() < 1e-4, d.mean()
    assert (d > 1e-4).mean() < 5e-3, (d > 1e-4).mean()
    assert flips.mean() < 5e-3, flips.mean()
    assert (cnt >= 8).all() and (cnt <= 80).all()


def test_cover_scene_matches_jax_kernel():
    """Cover scene at 32x16, 4 spp, depth 10.  Knife-edge flips on the
    r=1000 ground sphere exceed the repo's bound here: XLA's CPU build of
    the interpreted kernel rounds the |oc|^2 cancellation (~1e6, f32 ulp
    0.06) differently from PyTorch.  The bound is the gap the JAX package's
    own two paths show on this scene (persistent kernel in interpret mode
    vs the jnp path, 32x16, 4 spp, depth 10, scene PRNGKey(0), render
    PRNGKey(1): mean 2.3e-4, 2.1% of channels above 1e-4)."""
    jscene, jcam, _ = spt.presets.PRESETS["cover"].build(jax.random.PRNGKey(0))
    d, flips, _ = _block_pair(jscene, jcam, 32, 16, 4)
    assert d.mean() < 2.3e-4, d.mean()
    assert (d > 1e-4).mean() < 0.021, (d > 1e-4).mean()
    assert flips.mean() < 0.021, flips.mean()


def test_ragged_single_bank_matches_jax_kernel():
    # 37 x 13 = 481 pixels: fewer than one 1024-position block, one bank.
    assert persistent.bank_geometry(481, persistent.GPU_BANKS) == (1, 481)
    jscene = spt.reference_scene()
    d, flips, _ = _block_pair(
        jscene, spt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90),
        37, 13, 4, seed=11,
    )
    assert d.mean() < 1e-4, d.mean()
    assert (d > 1e-4).mean() < 5e-3, (d > 1e-4).mean()
    assert flips.mean() < 5e-3


@pytest.mark.parametrize("p", [130, 5000, 1024 * 16 + 777, 960_000])
def test_bank_geometry_matches_jax_layout(p):
    nb, n_lanes, *_ = banked_lane_layout(jnp.arange(p), 7, DEFAULT_BANKS)
    assert persistent.bank_geometry(p, DEFAULT_BANKS) == (nb, n_lanes)


def test_padding_slots_reject_themselves():
    ts = convert_scene(spt.three_sphere_scene(), "cpu")   # 5 spheres -> 8 slots
    cam = tpt.make_camera(**_TRIO_CAM, device="cpu")
    cfg = tpt.RenderConfig(width=24, height=12, spp=2, max_depth=6, use_pallas=True)
    tables, sky6, cam19 = _persistent_args(ts, cam, cfg)
    padded = persistent.pad_scene_tables(tables)
    assert padded[0].shape[0] == 8 and torch.isnan(padded[3][5:]).all()
    args = (sky6, cam19, tpt.make_key(2), 0, 2, 6, 24, 12)
    pix = torch.arange(24 * 12)
    a, ca = persistent.render_block_persistent(pix, tables, *args, return_counts=True)
    b, cb = persistent.render_block_persistent(pix, padded, *args, return_counts=True)
    assert torch.equal(a, b) and torch.equal(ca, cb)


def test_balanced_accumulate_bit_identical():
    scene = tpt.reference_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device="cpu")
    base = dict(width=40, height=26, spp=8, max_depth=6, use_pallas=True)
    key = tpt.make_key(5)
    cfg_bal = tpt.RenderConfig(**base, balance_probe_spp=2)
    st = tpt.accumulate(tpt.init_state(cfg_bal, key, device="cpu"), scene, cam, cfg_bal, 8)
    cfg = tpt.RenderConfig(**base)
    st2 = tpt.accumulate(tpt.init_state(cfg, key, device="cpu"), scene, cam, cfg, 2)
    st2 = tpt.accumulate(st2, scene, cam, cfg, 6)
    assert torch.equal(st.accum, st2.accum)
    assert st.sample_count == 8


@pytest.mark.parametrize("n", [1, 2, 8, 63, 64, 65, 100, 128, 129, 256, 500, 5000])
def test_sample_groups_depend_on_the_sample_count_alone(n):
    k = persistent.SAMPLE_GROUP
    want = 1 if n <= k else (n + k - 1) // k
    assert persistent.sample_groups(n) == want
    assert (want - 1) * k < n <= want * k


def _group_case(lit):
    """Pixels of a small scene (lit: its three spheres emit) at just above
    one sample group."""
    scene = tpt.with_ground_plane(tpt.three_sphere_scene(device="cpu"))
    if lit:
        e = torch.zeros((scene.num_spheres, 3))
        e[1:4] = torch.tensor([3.0, 2.0, 1.0])
        scene = scene.replace(emission=e)
    cam = tpt.make_camera(**_TRIO_CAM, device="cpu")
    cfg = tpt.RenderConfig(width=48, height=24, max_depth=6, rr_start_depth=2, use_pallas=True)
    n = persistent.SAMPLE_GROUP + 3
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    args = (tables, sky6, cam19, tpt.make_key(6), 9, n, cfg.max_depth, cfg.width, cfg.height)
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth,
              plane7=scene.plane, emission=scene.emission)
    return args, kw, n


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "emissive"])
def test_plain_version_adds_sample_groups_in_order(lit):
    """Just above one group: the plain version's sums and counts are each
    group's per-sample radiances summed from 0 in sample order, then the
    groups' sums added from 0 in group order, bit for bit."""
    args, kw, n = _group_case(lit)
    assert persistent.sample_groups(n) == 2
    tables, sky6, cam19, key, offset, _, depth, w, h = args
    pix = torch.tensor([5, 77, 300, 301, 640, 1100])
    got, cnt = persistent.render_block_persistent_reference(pix, *args, **kw, return_counts=True)
    # Per-sample radiance, traced as the plain version batches it (one
    # chunk of every (pixel, sample) pair, pixels in ascending order).
    k0, k1 = persistent.key_words(key)
    sid = (offset + torch.arange(n)).repeat_interleave(pix.shape[0])
    rad, it = persistent._trace_plain(
        pix.repeat(n), sid, tables, sky6, cam19, kw["plane7"], k0, k1, depth, w, h,
        kw["t_min"], kw["t_max"], kw["rr_start_depth"], kw["emission"])
    rad, it = rad.reshape(n, -1, 3), it.reshape(n, -1)
    want, want_cnt = torch.zeros_like(got), torch.zeros_like(cnt)
    for g0 in range(0, n, persistent.SAMPLE_GROUP):
        grp, grp_cnt = torch.zeros_like(got), torch.zeros_like(cnt)
        for j in range(g0, min(g0 + persistent.SAMPLE_GROUP, n)):
            grp, grp_cnt = grp + rad[j], grp_cnt + it[j]
        want, want_cnt = want + grp, want_cnt + grp_cnt
    assert torch.equal(got, want) and torch.equal(cnt, want_cnt)
    assert (cnt >= n).all() and (got > 0).any()


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "emissive"])
def test_plain_version_permutes_with_the_pixels_across_groups(lit):
    args, kw, n = _group_case(lit)
    gen = torch.Generator().manual_seed(3)
    pix = torch.randperm(48 * 24, generator=gen)[:10]
    perm = torch.randperm(10, generator=gen)
    a, ca = persistent.render_block_persistent_reference(pix, *args, **kw, return_counts=True)
    b, cb = persistent.render_block_persistent_reference(pix[perm], *args, **kw,
                                                         return_counts=True)
    assert torch.equal(a[perm], b) and torch.equal(ca[perm], cb)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (runs where
    CUDA and nvcc are present; chip_smoke.py holds the same comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    scene = tpt.with_ground_plane(tpt.three_sphere_scene(device="cuda"))
    cam = tpt.make_camera(**_TRIO_CAM, device="cuda")
    cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=10, rr_start_depth=2, use_pallas=True)
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    args = (tables, sky6, cam19, tpt.make_key(1), 0, 8, 10, 48, 24)
    kw = dict(rr_start_depth=2, return_counts=True, plane7=scene.plane)
    pix = torch.arange(48 * 24, device="cuda")
    a, ca = persistent.render_block_persistent(pix, *args, **kw)
    b, cb = persistent.render_block_persistent_reference(pix, *args, **kw)
    d = np.abs(_gamma(a.cpu(), 8) - _gamma(b.cpu(), 8))
    assert d.mean() < 1e-4 and (d > 1e-4).mean() < 5e-3
    assert (ca != cb).float().mean().item() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,w,h,spp,rr,perm",
    [("plane", 47, 23, 7, 2, False), ("plane", 47, 23, 1, 0, False),
     ("cover", 53, 29, 7, 0, False), ("cover", 53, 29, 1, 3, True),
     ("plane", 47, 23, 70, 2, False), ("cover", 53, 29, 130, 0, True)],
    ids=["plane-7spp-rr", "plane-1spp", "cover-7spp", "cover-1spp-rr-perm",
         "plane-70spp-rr", "cover-130spp-perm"],
)
def test_kernel_is_bit_exact_on_card(name, w, h, spp, rr, perm):
    """The kernel's lanes fetch work items (a pixel and one group of its
    samples) from a counter and regenerate in one flat loop, so which lane
    sums an item changes from run to run but no value does: over P not a
    multiple of the grid's lanes (a permuted subset in the perm cases), at
    one sample group and at several (the partial sums added by the
    combine), sums and counts equal the plain version's bit for bit, and
    two launches in a row give identical outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    if name == "plane":
        scene = tpt.with_ground_plane(tpt.three_sphere_scene(device="cuda"))
        cam = tpt.make_camera(**_TRIO_CAM, device="cuda")
    else:
        scene = tpt.compact_scene(tpt.cover_scene(0, device="cuda"))
        cam = tpt.PRESETS["cover"].camera_fn("cuda")
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=10, rr_start_depth=rr,
                           use_pallas=True)
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    args = (tables, sky6, cam19, tpt.make_key(3), 5, spp, 10, w, h)
    kw = dict(rr_start_depth=rr, return_counts=True, plane7=scene.plane)
    gen = torch.Generator().manual_seed(4)
    pix = (torch.randperm(w * h, generator=gen)[: w * h - 101] if perm
           else torch.arange(w * h)).to("cuda")
    before = tracing.counts()
    a, ca = persistent.render_block_persistent(pix, *args, **kw)
    a2, ca2 = persistent.render_block_persistent(pix, *args, **kw)
    assert (tracing.counts() - before)["launch.persistent"] == 2
    b, cb = persistent.render_block_persistent_reference(pix, *args, **kw)
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert torch.equal(a, a2) and torch.equal(ca, ca2)
    assert (ca >= spp).all() and (a > 0).any()


@pytest.mark.cuda
def test_split_counters_read_each_launch_on_card():
    """``launch.persistent.split`` counts the launches with more than one
    sample group, ``persistent.items`` every launch's pixels x groups; a
    permuted ``pixel_ids`` at several groups gives the permuted sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    scene = tpt.with_ground_plane(tpt.three_sphere_scene(device="cuda"))
    cam = tpt.make_camera(**_TRIO_CAM, device="cuda")
    cfg = tpt.RenderConfig(width=40, height=20, spp=8, max_depth=10, use_pallas=True)
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    pix = torch.arange(800, device="cuda")
    n_split = 2 * persistent.SAMPLE_GROUP + 1
    for spp, groups in ((8, 1), (persistent.SAMPLE_GROUP, 1), (n_split, 3)):
        before = tracing.counts()
        a, ca = persistent.render_block_persistent(pix, tables, sky6, cam19, tpt.make_key(2), 0,
                                                   spp, 10, 40, 20, plane7=scene.plane,
                                                   return_counts=True)
        since = tracing.counts() - before
        assert persistent.sample_groups(spp) == groups
        assert since["launch.persistent"] == 1
        assert since["launch.persistent.split"] == int(groups > 1)
        assert since["persistent.items"] == 800 * groups
    perm = torch.randperm(800, generator=torch.Generator().manual_seed(5)).to("cuda")
    b, cb = persistent.render_block_persistent(pix[perm], tables, sky6, cam19, tpt.make_key(2), 0,
                                               n_split, 10, 40, 20, plane7=scene.plane,
                                               return_counts=True)
    assert torch.equal(a[perm], b) and torch.equal(ca[perm], cb)
