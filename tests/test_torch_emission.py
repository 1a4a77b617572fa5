"""Emissive spheres (``Scene.emission``) on the forward render, on the
routes that carry them, and their refusal everywhere else.

On the CPU ``render_block_persistent`` takes its plain version, which adds
the emission term in the kernel's formulation; it is held bit for bit
against the benchmark's frozen reference of lit scenes
(``port_bench/pb_reference/forward_lit.py``, which imports nothing of the
port) on smallpt's Cornell box and on cover scenes with random emitters.  A
scene without emission, or with an all-zero table, renders the sums it
rendered before emission existed (``forward.py``, the frozen reference of
unlit scenes).  The regeneration and plain routes (and ``fit`` on the
CPU's plain route) give the reference's sums, paths and loss; every route
that adds no emitted light raises on an emissive scene (gradients of
emission: ``test_torch_emission_grad.py``).  The ``cuda`` tests hold the
kernel's emissive build against the plain version on the card:

    python -m pytest --noconftest tests/test_torch_emission.py -m cuda
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import checkpoint, convert, tracing
from simplepathtracer_tpu_torch.camera import view_frame
from simplepathtracer_tpu_torch.ops import grad as fused
from simplepathtracer_tpu_torch.ops import grad_regen, persistent
from simplepathtracer_tpu_torch.ops.sampling import fold_in, ray_keys
from simplepathtracer_tpu_torch.inverse import fit_sharded
from simplepathtracer_tpu_torch.render import _persistent_args, render_pixel_block, trace_rays_pallas

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pb_reference import camera as ref_camera, forward, forward_lit, grad_lit  # noqa: E402


def _smallpt(device="cpu"):
    scene, cam, cfg = tpt.PRESETS["smallpt"].build(0, device=device)
    return scene, cam, cfg


def _cover(device="cpu"):
    return tpt.compact_scene(tpt.cover_scene(0, device=device)), tpt.PRESETS["cover"].camera_fn(device)


def _random_emitters(scene, seed):
    """Emission on a random subset of the spheres (about one in five)."""
    gen = torch.Generator().manual_seed(seed)
    s = scene.num_spheres
    on = torch.rand(s, generator=gen) < 0.2
    on[seed % s] = True
    e = torch.rand((s, 3), generator=gen) * 4.0 * on[:, None]
    return scene.replace(emission=e.to(scene.device))


def _ref_tables(scene):
    """The frozen reference's tables of a port scene."""
    t = {k: getattr(scene, k) for k in ("centers", "radii", "albedo", "fuzz", "ior",
                                         "sky_lo", "sky_hi")}
    t["material"] = scene.material.to(torch.int64)
    t["emission"] = (scene.emission if scene.emission is not None
                     else torch.zeros((scene.num_spheres, 3)))
    return t


def _rcfg(cfg):
    return {k: getattr(cfg, k) for k in ("width", "height", "spp", "max_depth", "t_min",
                                         "t_max", "gamma", "rr_start_depth")}


def _kernel_call(scene, cam, cfg, key, pix, spp):
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    args = (pix, tables, sky6, cam19, key, 0, spp, cfg.max_depth, cfg.width, cfg.height)
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, rr_start_depth=cfg.rr_start_depth,
              plane7=scene.plane)
    return args, kw


@pytest.mark.parametrize("case", ["smallpt", "cover-1", "cover-2", "cover-3"])
def test_plain_version_is_the_lit_reference_bit_for_bit(case):
    if case == "smallpt":
        scene, cam, cfg = _smallpt()
        cfg = cfg.replace(width=48, height=24, spp=8)
    else:
        scene, cam = _cover()
        scene = _random_emitters(scene, int(case[-1]))
        cfg = tpt.RenderConfig(width=24, height=16, spp=2, max_depth=6, rr_start_depth=2,
                               use_pallas=True)
    key = tpt.make_key(17)
    pix = torch.arange(cfg.num_pixels)
    args, kw = _kernel_call(scene, cam, cfg, key, pix, cfg.spp)
    before = tracing.counts()
    got, cnt = persistent.render_block_persistent(*args, **kw, return_counts=True,
                                                  emission=scene.emission)
    assert (tracing.counts() - before)["plain.render_block_persistent_reference"] == 1
    cam19 = args[3]
    want, work = forward_lit.pixel_sums(_ref_tables(scene), cam19, tuple(int(k) for k in key),
                                        pix, 0, cfg.spp, _rcfg(cfg))
    assert torch.equal(got, want)
    assert work["segments"] == int(cnt.sum())
    dark, _ = forward_lit.pixel_sums(_ref_tables(scene), cam19, tuple(int(k) for k in key), pix, 0,
                                     cfg.spp, _rcfg(cfg), emit=False)
    assert not torch.equal(got, dark)


@pytest.mark.parametrize("case", ["cover", "three_sphere"])
@pytest.mark.parametrize("emission", ["none", "zeros"])
def test_no_or_zero_emission_renders_the_unlit_sums(case, emission):
    if case == "cover":
        scene, cam = _cover()
        cfg = tpt.RenderConfig(width=24, height=16, spp=2, max_depth=10, use_pallas=True)
    else:
        scene = tpt.three_sphere_scene(device="cpu")
        cam = tpt.PRESETS["three_sphere"].camera_fn("cpu")
        cfg = tpt.RenderConfig(width=32, height=16, spp=4, max_depth=10, rr_start_depth=2,
                               use_pallas=True)
    if emission == "zeros":
        scene = scene.replace(emission=torch.zeros((scene.num_spheres, 3)))
    key = tpt.make_key(4)
    pix = torch.arange(cfg.num_pixels)
    args, kw = _kernel_call(scene, cam, cfg, key, pix, cfg.spp)
    want, _ = forward.pixel_sums(_ref_tables(scene), args[3], tuple(int(k) for k in key), pix, 0,
                                 cfg.spp, _rcfg(cfg))
    got = persistent.render_block_persistent(*args, **kw, emission=scene.emission)
    direct = persistent.render_block_persistent_reference(*args, **kw, emission=scene.emission)
    assert torch.equal(got, want) and torch.equal(direct, want)
    assert scene.emitters() == 0


def _target(cfg):
    return torch.zeros((cfg.height, cfg.width, 3))


def _routes():
    """(name, call(scene, cam, cfg)) for each route but the persistent one;
    those in ``CARRIES`` add emission, the others refuse it."""
    def keys(cfg):
        pix = torch.arange(cfg.num_pixels)
        return ray_keys(tpt.make_key(1), pix, torch.zeros_like(pix))

    def rays(cfg):
        n = cfg.num_pixels
        o = torch.zeros((n, 3)) + torch.tensor([50.0, 40.0, 100.0])
        d = torch.nn.functional.normalize(torch.randn(n, 3), dim=-1)
        return o, d

    def trace_rays(flags):
        def call(s, c, cfg):
            o, d = rays(cfg)
            return tpt.trace_rays(o, d, keys(cfg), s, cfg.replace(use_pallas=False, **flags))
        return call

    def render_pixels(flags):
        def call(s, c, cfg):
            pix = torch.arange(cfg.num_pixels)
            return tpt.render_pixels(s, c, cfg.replace(**dict({"use_pallas": False}, **flags)),
                                     tpt.make_key(1), pix, torch.zeros_like(pix))
        return call

    def block(flags):
        def call(s, c, cfg):
            pix = torch.arange(cfg.num_pixels)
            return render_pixel_block(s, c, cfg.replace(use_pallas=False, **flags),
                                      tpt.make_key(1), pix, 0, 2)
        return call

    return [
        ("trace_rays eager", trace_rays({})),
        ("trace_rays hits", trace_rays({"use_pallas_hits": True})),
        ("trace_rays fused", trace_rays({"use_pallas_grad": True})),
        ("trace_rays_pallas", lambda s, c, cfg: trace_rays_pallas(*rays(cfg), keys(cfg), s, cfg)),
        ("render_pixels bounce-step", render_pixels({"use_pallas": True})),
        ("render_pixels eager", render_pixels({})),
        ("render_pixels fused raygen", render_pixels({"use_pallas_grad": True})),
        ("trace_pixels_fused", lambda s, c, cfg: fused.trace_pixels_fused(c, keys(cfg), s, cfg)),
        ("trace_rays_fused", lambda s, c, cfg: fused.trace_rays_fused(*rays(cfg), keys(cfg), s, cfg)),
        ("regen route", block({"use_pallas_grad": True, "grad_regen": True})),
        ("render_block_grad_regen", lambda s, c, cfg: grad_regen.render_block_grad_regen(
            s, c, cfg, tpt.make_key(1), torch.arange(cfg.num_pixels), 0, 2)),
        ("fit", lambda s, c, cfg: tpt.fit(s, _target(cfg), c, cfg, tpt.make_key(2), steps=1,
                                          device="cpu")),
        ("fit_camera", lambda s, c, cfg: tpt.fit_camera(s, _target(cfg), c, cfg, tpt.make_key(2),
                                                        steps=1, device="cpu")),
        ("fit_sharded", lambda s, c, cfg: fit_sharded(s, _target(cfg), c, cfg, tpt.make_key(2),
                                                      None, steps=1, device="cpu")),
    ]


def _cam19(cam, cfg):
    return ref_camera.camera_constants(
        {k: getattr(cam, k) for k in ("origin", "lookat", "vup", "vfov_deg", "aperture",
                                       "focus_dist")}, cfg.width, cfg.height)


def _paths(scene, cam, cfg):
    """(pixel ids, sample ids, key, the reference's radiance per path) of
    every pixel's samples 0 and 1."""
    pix = torch.arange(cfg.num_pixels).repeat(2)
    sid = torch.arange(2).repeat_interleave(cfg.num_pixels)
    key = tpt.make_key(1)
    want, _, _ = forward_lit.trace(_ref_tables(scene), _cam19(cam, cfg),
                                   tuple(int(k) for k in key), pix, sid, _rcfg(cfg))
    return pix, sid, key, want


def _agrees_trace_rays(scene, cam, cfg):
    pix, sid, key, want = _paths(scene, cam, cfg)
    ray = ref_camera.camera_ray(_cam19(cam, cfg), tuple(int(k) for k in key), pix, sid,
                                cfg.width, cfg.height)
    got = tpt.trace_rays(torch.stack(ray[:3], -1), torch.stack(ray[3:], -1),
                         ray_keys(key, pix, sid), scene, cfg.replace(use_pallas=False))
    return got, want


def _agrees_render_pixels(scene, cam, cfg):
    pix, sid, key, want = _paths(scene, cam, cfg)
    return tpt.render_pixels(scene, cam, cfg.replace(use_pallas=False), key, pix, sid), want


def _agrees_block(regen_call):
    def check(scene, cam, cfg):
        pix = torch.arange(cfg.num_pixels)
        key = tpt.make_key(1)
        want, _ = forward_lit.pixel_sums(_ref_tables(scene), _cam19(cam, cfg),
                                         tuple(int(k) for k in key), pix, 0, 2, _rcfg(cfg))
        flags = dict(use_pallas=False, use_pallas_grad=True, grad_regen=True)
        if regen_call:
            got = grad_regen.render_block_grad_regen(scene, cam, cfg.replace(**flags), key, pix,
                                                     0, 2)
        else:
            got = render_pixel_block(scene, cam, cfg.replace(**flags), key, pix, 0, 2)
        return got, want
    return check


def _agrees_fit(scene, cam, cfg):
    """One step of ``fit`` (soft 0.02, the decoupled loss, every leaf) on the
    CPU's plain route: its loss is the lit reference's, and the emission
    leaf moves."""
    key = tpt.make_key(2)
    fitted, losses = tpt.fit(scene, _target(cfg), cam, cfg, key, steps=1, device="cpu")
    leaves = {k: getattr(scene, k) for k in grad_lit.SCENE_LEAVES}
    static = {"scene": dict(_ref_tables(scene)),
              "camera": {k: getattr(cam, k) for k in ("origin", "lookat", "vup", "vfov_deg",
                                                       "aperture", "focus_dist")}}
    want, grads, _ = grad_lit.loss_and_grad(
        leaves, static, _target(cfg), tuple(int(k) for k in fold_in(key, 0)),
        _rcfg(cfg), 0.02, decoupled=True)
    assert not torch.equal(fitted.emission, scene.emission) and grads["emission"].norm() > 0
    return torch.tensor([losses[0]]), torch.tensor([want])


# The routes that add emission, and what each is held to: the paths' or
# the sums' radiance of ``forward_lit`` (the regeneration and plain routes
# share its formulation at this size: bit for bit, held to 1e-6 for the
# sums' order), or the loss of ``grad_lit``.
CARRIES = {
    "trace_rays eager": _agrees_trace_rays,
    "render_pixels eager": _agrees_render_pixels,
    "regen route": _agrees_block(False),
    "render_block_grad_regen": _agrees_block(True),
    "fit": _agrees_fit,
}


@pytest.mark.parametrize("name,call", _routes(), ids=[n for n, _ in _routes()])
def test_routes_without_emission_refuse_an_emissive_scene(name, call):
    """Each route that adds no emitted light raises on an emissive scene;
    each that adds it (``CARRIES``: the regeneration and plain routes, and
    ``fit`` on the CPU's plain route) agrees with the lit reference."""
    scene, cam, cfg = _smallpt()
    cfg = cfg.replace(width=8, height=4, spp=2, max_depth=3)
    if name in CARRIES:
        got, want = CARRIES[name](scene, cam, cfg)
        assert want.abs().sum() > 0
        assert torch.allclose(got, want, rtol=1e-6, atol=0.0), name
        return
    with pytest.raises(NotImplementedError, match="emission"):
        call(scene, cam, cfg)


def test_render_adds_emission_and_names_its_emitters():
    scene, cam, cfg = _smallpt()
    cfg = cfg.replace(width=16, height=12, spp=2)
    with tracing.enabled():
        img = tpt.render(scene, cam, cfg, tpt.make_key(3))
        rec = [r for r in tracing.spans() if r["name"] == "spt.render"]
    assert rec and rec[0]["counts"]["emitters"] == 1
    dark = tpt.render(scene.replace(emission=None), cam, cfg, tpt.make_key(3))
    assert float(dark.max()) == 0.0 and float(img.max()) > 0.0


def test_convert_refuses_an_emissive_scene():
    scene, _, _ = _smallpt()
    with pytest.raises(ValueError, match="emission"):
        convert.scene_to_numpy(scene)
    leaves = convert.scene_to_numpy(scene.replace(emission=None))
    assert set(leaves) == set(convert.SCENE_LEAVES)
    back = convert.convert_scene(leaves, "cpu")
    assert torch.equal(back.centers, scene.centers) and back.emission is None


def test_checkpoint_carries_the_emission(tmp_path):
    scene, cam, cfg = _smallpt()
    cfg = cfg.replace(width=8, height=6, spp=2)
    st = tpt.accumulate(tpt.init_state(cfg, tpt.make_key(5), device="cpu"), scene, cam, cfg, 2)
    path = checkpoint.save(str(tmp_path / "lit.npz"), st, scene, cfg, cam)
    st2, scene2, cfg2, _ = checkpoint.load(path, device="cpu")
    assert torch.equal(scene2.emission, scene.emission)
    assert torch.equal(st2.accum, st.accum) and cfg2 == cfg
    more = tpt.accumulate(st2, scene2, cam, cfg2, 2)
    want = tpt.accumulate(st, scene, cam, cfg, 2)
    assert torch.equal(more.accum, want.accum)
    unlit = tmp_path / "unlit.npz"
    checkpoint.save(str(unlit), st, scene.replace(emission=None), cfg, cam)
    assert checkpoint.load(str(unlit), device="cpu")[1].emission is None


def test_smallpt_camera_is_smallpt_s_basis():
    """smallpt: d = normalise(0, -0.042612, -1), cx = (w .5135 / h, 0, 0),
    cy = normalise(cx x d) .5135; a pixel's direction d + cx (x/w - .5) +
    cy (y/h - .5), y up."""
    _, cam, cfg = _smallpt()
    u, v, lower_left, hor, ver = view_frame(cam, cfg.width, cfg.height)
    d = np.array([0.0, -0.042612, -1.0])
    d /= np.linalg.norm(d)
    cx = np.array([cfg.width * 0.5135 / cfg.height, 0.0, 0.0])
    cy = np.cross(cx, d)
    cy = cy / np.linalg.norm(cy) * 0.5135
    np.testing.assert_allclose(u.numpy(), [1.0, 0.0, 0.0], atol=1e-6)
    assert abs(float(v @ torch.tensor(d, dtype=torch.float32))) < 1e-6 and float(v[1]) > 0.99
    np.testing.assert_allclose(hor.numpy(), cx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ver.numpy(), cy, rtol=1e-5, atol=1e-6)
    centre = (lower_left + 0.5 * hor + 0.5 * ver - cam.origin).numpy()
    np.testing.assert_allclose(centre / np.linalg.norm(centre), d, atol=1e-6)
    assert math.isclose(float(cam.vfov_deg), math.degrees(2 * math.atan(0.5135 / 2)), rel_tol=1e-6)
    np.testing.assert_allclose(cam.origin.numpy(), [50.0, 52.0, 295.6])
    assert (cfg.width, cfg.height, cfg.rr_start_depth, cfg.max_depth, cfg.gamma) == (
        1024, 768, 5, 30, 2.2)


# ---- on the card -------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smallpt", "smallpt-ragged-perm", "cover-emitters",
                                  "plane-emitters", "smallpt-130spp-perm",
                                  "cover-emitters-70spp"])
def test_emissive_build_is_bit_exact_on_card(case):
    """The kEmit build against the plain version, bit for bit, over a pixel
    count that is no multiple of the grid's lanes (a permuted subset in the
    perm cases), at one sample group and, in the cases that name their spp,
    at several, twice in a row; each launch counts
    ``launch.persistent.emit``."""
    _need_card()
    if case.startswith("smallpt"):
        scene, cam, cfg = _smallpt("cuda")
        cfg = cfg.replace(width=53, height=29, spp=130 if "130spp" in case else 7)
    elif case.startswith("cover-emitters"):
        scene, cam = _cover("cuda")
        scene = _random_emitters(scene, 5)
        cfg = tpt.RenderConfig(width=47, height=23, spp=70 if "70spp" in case else 5,
                               max_depth=10, rr_start_depth=3, use_pallas=True)
    else:
        scene = _random_emitters(tpt.with_ground_plane(tpt.three_sphere_scene(device="cuda")), 6)
        cam = tpt.PRESETS["three_sphere"].camera_fn("cuda")
        cfg = tpt.RenderConfig(width=47, height=23, spp=7, max_depth=10, rr_start_depth=2,
                               use_pallas=True)
    n = cfg.num_pixels
    gen = torch.Generator().manual_seed(8)
    pix = (torch.randperm(n, generator=gen)[: n - 101] if case.endswith("perm")
           else torch.arange(n)).to("cuda")
    args, kw = _kernel_call(scene, cam, cfg, tpt.make_key(9), pix, cfg.spp)
    before = tracing.counts()
    a, ca = persistent.render_block_persistent(*args, **kw, return_counts=True,
                                               emission=scene.emission)
    a2, _ = persistent.render_block_persistent(*args, **kw, return_counts=True,
                                               emission=scene.emission)
    since = tracing.counts() - before
    assert since["launch.persistent"] == 2 and since["launch.persistent.emit"] == 2
    b, cb = persistent.render_block_persistent_reference(*args, **kw, return_counts=True,
                                                         emission=scene.emission)
    assert torch.equal(a, b) and torch.equal(ca, cb) and torch.equal(a, a2)
    dark = persistent.render_block_persistent(*args, **kw)
    assert not torch.equal(a, dark)


@pytest.mark.cuda
def test_unlit_build_is_unchanged_on_card():
    """On the cover frame (cut to 61 x 37) no emission and an all-zero table
    launch the build without emission and give the plain version's sums."""
    _need_card()
    scene, cam = _cover("cuda")
    cfg = tpt.RenderConfig(width=61, height=37, spp=6, max_depth=10, use_pallas=True)
    pix = torch.arange(cfg.num_pixels, device="cuda")
    args, kw = _kernel_call(scene, cam, cfg, tpt.make_key(10), pix, cfg.spp)
    before = tracing.counts()
    a = persistent.render_block_persistent(*args, **kw)
    z = persistent.render_block_persistent(*args, **kw,
                                           emission=torch.zeros((scene.num_spheres, 3),
                                                                device="cuda"))
    since = tracing.counts() - before
    assert since["launch.persistent"] == 2 and since["launch.persistent.emit"] == 0
    b = persistent.render_block_persistent_reference(*args, **kw)
    assert torch.equal(a, b) and torch.equal(z, b)


@pytest.mark.cuda
def test_render_takes_the_emissive_build_on_card():
    _need_card()
    scene, cam, cfg = _smallpt("cuda")
    cfg = cfg.replace(width=64, height=48, spp=4)
    before = tracing.counts()
    img = tpt.render(scene, cam, cfg, tpt.make_key(11))
    since = tracing.counts() - before
    assert since["launch.persistent.emit"] == 1 and since["launch.persistent"] == 1
    assert not [k for k in since if k.startswith("plain.")]
    assert torch.isfinite(img).all() and float(img.max()) > 0.0


def test_emitter_count_follows_in_place_changes():
    """The count is read from the device once a tensor version: a render loop
    does not wait on it, and an in-place change is read anew."""
    scene, _, _ = _smallpt()
    assert scene.emitters() == 1
    scene.emission[0, 1] = 0.5
    assert scene.emitters() == 2
    scene.emission.zero_()
    assert scene.emitters() == 0 and tpt.Scene.emitters(scene.replace(emission=None)) == 0
