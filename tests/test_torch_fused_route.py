"""Routing of the fused gradient kernels and of camera gradients in the
port (the JAX package's ``render.py:203-232, 564-594, 735-740``), checked
through the plain versions' call counters on the CPU:

* ``camera_grad`` never takes the regeneration kernels, and its spp chunk
  comes from the fused route's budget;
* plane scenes take the eager bounce (the fused kernels are sphere-only);
* ``render_pixels`` makes the fused route's camera rays with raygen unless
  ``camera_grad`` asks for the differentiable ``generate_rays``;
* the backward skips the buckets when no table leaf needs a gradient;
* a chunked camera-leaf gradient is rematerialized per chunk, and equals
  the unchunked one to rounding (sums in another order: rtol 1e-6);
* a camera leaf that requires a gradient without ``camera_grad`` makes
  the chunks rematerialize wherever the route differentiates through the
  camera (the eager route), and not where it detaches it (the regeneration
  kernels, the fused route's raygen).
"""

import importlib

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import bucket, grad as fg, grad_regen
from simplepathtracer_tpu_torch.ops.sampling import ray_keys

port_render = importlib.import_module("simplepathtracer_tpu_torch.render")


def _setup(plane=False, **cfg_kw):
    scene = tpt.three_sphere_scene(device="cpu")
    if plane:
        scene = tpt.with_ground_plane(scene)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cfg = tpt.RenderConfig(width=12, height=6, spp=2, max_depth=3, **cfg_kw)
    return scene, cam, cfg, torch.full((6, 12, 3), 0.25)


def _camera_grads(scene, cam, cfg, target, **kw):
    params, cam0 = tpt.split_camera(cam)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = tpt.camera_pixel_loss(params, cam0, scene, target, cfg, tpt.make_key(1), device="cpu",
                                 **kw)
    return loss, torch.autograd.grad(loss, list(params.values()))


def test_camera_grad_skips_the_regen_kernels():
    scene, cam, cfg, target = _setup(use_pallas_grad=True, grad_regen=True)
    regen, fused = grad_regen.regen_fwd_reference.calls, fg.grad_fwd_reference.calls
    loss, grads = _camera_grads(scene, cam, cfg, target)
    assert grad_regen.regen_fwd_reference.calls == regen
    assert fg.grad_fwd_reference.calls == fused + cfg.max_depth
    assert torch.isfinite(loss) and grads[0].abs().max() > 0
    # The chunk on CUDA: the fused budget, not the regen kernels'.
    cover = tpt.PRESETS["cover"].config
    cam_cfg = tpt.grad_safe_config(cover.replace(camera_grad=True), "cuda")
    ray_bounces = cover.num_pixels * cover.max_depth
    assert cam_cfg.spp_chunk == port_render._GRAD_RAY_BOUNCE_BUDGET_FUSED // ray_bounces
    assert tpt.grad_safe_config(cover, "cuda").spp_chunk == (
        port_render._GRAD_ITER_BUDGET_REGEN // ray_bounces)
    assert not port_render._uses_regen(cam_cfg) and port_render._uses_regen(
        tpt.grad_safe_config(cover, "cuda"))


def test_plane_scenes_take_the_eager_bounce():
    scene, cam, cfg, target = _setup(plane=True)
    calls = fg.grad_fwd_reference.calls, fg.raygen_reference.calls
    out = []
    for c in (cfg.replace(use_pallas_grad=True), cfg):
        params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
        loss = tpt.pixel_loss(params, scene, target, cam, c, tpt.make_key(1), device="cpu")
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert (fg.grad_fwd_reference.calls, fg.raygen_reference.calls) == calls
    (l_f, g_f), (l_e, g_e) = out
    assert torch.equal(l_f, l_e) and all(torch.equal(a, b) for a, b in zip(g_f, g_e))
    with pytest.raises(ValueError, match="sphere-only"):
        fg.trace_rays_fused(torch.zeros((2, 3)), torch.ones((2, 3)),
                            ray_keys(tpt.make_key(1), torch.arange(2), 0),
                            scene, cfg)


@pytest.mark.parametrize("camera_grad", [False, True], ids=["raygen", "generate_rays"])
def test_render_pixels_camera_rays(camera_grad):
    scene, cam, cfg, _ = _setup(use_pallas_grad=True, camera_grad=camera_grad)
    calls = fg.raygen_reference.calls, fg.grad_fwd_reference.calls
    pids = torch.arange(cfg.num_pixels)
    rad = tpt.render_pixels(scene, cam, cfg, tpt.make_key(1), pids, torch.zeros_like(pids))
    assert rad.shape == (cfg.num_pixels, 3) and torch.isfinite(rad).all() and rad.max() > 0
    assert fg.raygen_reference.calls == calls[0] + (0 if camera_grad else 1)
    assert fg.grad_fwd_reference.calls == calls[1] + cfg.max_depth


def test_buckets_run_only_for_table_gradients():
    scene, cam, cfg, target = _setup(use_pallas_grad=True)
    calls = bucket.bucket_cols_reference.calls
    _camera_grads(scene, cam, cfg, target)
    assert bucket.bucket_cols_reference.calls == calls
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
    loss = tpt.pixel_loss(params, scene, target, cam, cfg, tpt.make_key(1), device="cpu")
    loss.backward()
    assert bucket.bucket_cols_reference.calls == calls + cfg.max_depth
    assert params["albedo"].grad.abs().max() > 0


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_camera_gradient_chunks_are_rematerialized(route, monkeypatch):
    flags = dict(use_pallas_grad=True) if route == "fused" else {}
    scene, cam, cfg, target = _setup(**flags)
    cfg = cfg.replace(spp=4)
    whole = _camera_grads(scene, cam, cfg, target)
    steps = []

    def counting(fn, *args, **kw):
        steps.append(args)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(port_render, "checkpoint", counting)
    chunked = _camera_grads(scene, cam, cfg.replace(spp_chunk=2), target)
    assert len(steps) == 2
    torch.testing.assert_close(chunked[0], whole[0], rtol=1e-6, atol=0)
    for a, b in zip(chunked[1], whole[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("route,remat", [("eager", True), ("regen", False), ("raygen", False)])
def test_camera_leaf_remat_follows_the_route(route, remat, monkeypatch):
    """A 48x24 render of 4 spp in chunks of 2 whose camera origin requires a
    gradient, ``camera_grad`` off: the eager route's chunks depend on the
    camera, so each is rematerialized, as ``jax.checkpoint`` would; the
    regeneration and raygen routes detach the camera, so nothing is."""
    flags = {"eager": {}, "regen": dict(use_pallas_grad=True, grad_regen=True,
                                         grad_regen_stream=False),
             "raygen": dict(use_pallas_grad=True)}[route]
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cam = cam.replace(origin=cam.origin.clone().requires_grad_(True))
    cfg = tpt.RenderConfig(width=48, height=24, spp=4, spp_chunk=2, max_depth=2, **flags)
    steps = []

    def counting(fn, *args, **kw):
        steps.append(args)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(port_render, "checkpoint", counting)
    rad = port_render.render_pixel_block(scene, cam, cfg, tpt.make_key(1),
                                         torch.arange(cfg.num_pixels), 0, cfg.spp)
    assert len(steps) == (2 if remat else 0)
    assert torch.isfinite(rad).all() and rad.max() > 0
    assert rad.requires_grad == remat
    if remat:
        (g,) = torch.autograd.grad(rad.sum(), [cam.origin])
        assert torch.isfinite(g).all() and g.abs().max() > 0


def test_fused_wrappers_refuse_other_devices():
    scene, cam, cfg, _ = _setup()
    inputs = grad_regen.scene_inputs(scene)
    call = fg.fused_call([t.to("meta") for t in inputs[:11]], inputs[11].to("meta"), 1, 2,
                         max_depth=3)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fg.grad_forward(call, torch.zeros((10, 4), **meta), torch.zeros((3, 4), **meta), None,
                        torch.zeros(4, dtype=torch.int32, **meta),
                        torch.zeros(4, dtype=torch.int32, **meta), 0)
