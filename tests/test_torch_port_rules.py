"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
its entry points never fall back silently to the CPU, the kernel wrappers
take their plain versions only for CPU tensors, paths not ported yet raise
instead of being ignored, and paths ported run."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import inverse
from simplepathtracer_tpu_torch.ops import (
    bounce_step,
    bucket,
    closest_hit,
    grad as fused,
    grad_regen,
    intersect,
    persistent,
)
from simplepathtracer_tpu_torch.render import _persistent_args

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "simplepathtracer_tpu_torch"


def test_port_imports_without_jax():
    modules = sorted(
        "simplepathtracer_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simplepathtracer_tpu'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert "simplepathtracer_tpu_torch.render" in modules


@pytest.mark.parametrize(
    "entry",
    [
        lambda: tpt.make_camera(),
        lambda: tpt.simple_scene(),
        lambda: tpt.cover_scene(0),
        lambda: tpt.PRESETS["cover"].build(0),
        lambda: tpt.init_state(tpt.RenderConfig(width=4, height=4), tpt.make_key(0)),
        lambda: tpt.convert_scene(
            {k: [0.0] for k in ("centers", "radii", "albedo", "material", "fuzz", "ior", "sky_lo", "sky_hi")}
        ),
    ],
)
def test_entry_point_without_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_wrapper_on_cpu_takes_plain_version():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    cfg = tpt.RenderConfig(width=16, height=8, spp=2, max_depth=4, use_pallas=True)
    launches = persistent.render_block_persistent.launches
    calls = persistent.render_block_persistent_reference.calls
    img = tpt.render(scene, cam, cfg, tpt.make_key(0))
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all() and img.max() > 0
    assert persistent.render_block_persistent.launches == launches
    assert persistent.render_block_persistent_reference.calls == calls + 1

    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        persistent.render_block_persistent(
            torch.arange(4, device="meta"), tables, sky6, cam19, tpt.make_key(0), 0, 1, 4, 16, 8
        )

    # The explicit-ray forward and the closest-hit kernels: bounce step
    # (render_pixels under use_pallas), closest hit with attributes (the
    # hits route) and closest hit (intersect_scene_pallas).
    wrappers = [
        (bounce_step.bounce_step, bounce_step.bounce_step_reference),
        (closest_hit.closest_hit_attrs, closest_hit.closest_hit_attrs_reference),
        (closest_hit.closest_hit, closest_hit.closest_hit_reference),
    ]
    before = [(k.launches.copy(), p.calls) for k, p in wrappers]
    pids = torch.arange(16 * 8)
    with torch.no_grad():
        rad = tpt.render_pixels(scene, cam, cfg, tpt.make_key(0), pids, torch.zeros_like(pids))
        tpt.render_pixels(scene, cam, cfg.replace(use_pallas=False, use_pallas_hits=True),
                          tpt.make_key(0), pids, torch.zeros_like(pids))
    o = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    hit = intersect.intersect_scene_pallas(o, d, torch.ones(4, dtype=torch.bool), scene)
    assert torch.isfinite(rad).all() and hit.hit.all()
    for (k, p), (launches, calls) in zip(wrappers, before):
        assert k.launches == launches
        assert p.calls > calls


@pytest.mark.parametrize(
    "fields,match",
    [
        (dict(rng_impl="rbg"), "rng_impl"),
    ],
    ids=["rng_impl"],
)
def test_unported_config_fields_raise(fields, match):
    with pytest.raises(NotImplementedError, match=match):
        tpt.RenderConfig(**fields)


@pytest.mark.parametrize(
    "fields,route",
    [
        # The per-bounce fused gradient kernels (regen off).
        (dict(use_pallas_grad=True), "fused"),
        # Camera gradients skip the regen kernels for the fused ones.
        (dict(use_pallas_grad=True, grad_regen=True, camera_grad=True), "fused"),
        # Without the fused kernels, camera gradients take the eager route.
        (dict(camera_grad=True), "eager"),
        # The closest-hit-attributes kernel under the eager bounce.
        (dict(use_pallas_hits=True), "hits"),
    ],
    ids=["use_pallas_grad", "regen_camera_grad", "camera_grad", "use_pallas_hits"],
)
def test_ported_config_fields_run(fields, route):
    """The config builds, and a camera-leaf gradient through it is finite,
    nonzero and taken on the route the flags name: the fused kernels' plain
    versions (the regen ones untouched), the closest-hit-attributes kernel's
    or the eager route (none)."""
    scene, cam, cfg, target = _tiny()
    cfg = cfg.replace(**fields)
    params, cam0 = tpt.split_camera(cam)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    counters = (fused.grad_fwd_reference, fused.grad_bwd_reference,
                grad_regen.regen_fwd_reference, closest_hit.closest_hit_attrs_reference)
    before = [c.calls for c in counters]
    loss = inverse.camera_pixel_loss(params, cam0, scene, target, cfg, tpt.make_key(0),
                                     device="cpu")
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert max(g.abs().max().item() for g in grads) > 0
    ran = [c.calls - b for c, b in zip(counters, before)]
    d = cfg.max_depth
    assert ran == {"fused": [d, d, 0, 0], "hits": [0, 0, 0, d], "eager": [0, 0, 0, 0]}[route]


@pytest.mark.parametrize("path", ["silhouette_softness", "softness", "pixel_loss_decoupled"])
def test_soft_silhouette_paths_run(path):
    """Soft silhouettes are ported: the config field, ``fit``'s default
    softness with geometry leaves, and the decoupled loss run (on the CPU,
    the eager route) and give finite results."""
    scene, cam, cfg, target = _tiny()
    if path == "silhouette_softness":
        img = tpt.render(scene, cam, cfg.replace(silhouette_softness=0.05), tpt.make_key(0))
        assert torch.isfinite(img).all() and img.max() > 0
    elif path == "softness":
        fitted, losses = tpt.fit(scene, target, cam, cfg, tpt.make_key(0), steps=1, device="cpu")
        assert np.isfinite(losses[0]) and not torch.equal(fitted.centers, scene.centers)
    else:
        params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
        loss = inverse.pixel_loss_decoupled(params, scene, target, cam,
                                            cfg.replace(silhouette_softness=0.05),
                                            tpt.make_key(0), device="cpu")
        (g,) = torch.autograd.grad(loss, [params["centers"]])
        assert torch.isfinite(loss) and torch.isfinite(g).all() and g.abs().max() > 0


def test_regen_config_is_accepted():
    cfg = tpt.RenderConfig(use_pallas_grad=True, grad_regen=True, grad_regen_banks=2,
                           grad_regen_stream=False)
    assert cfg.grad_regen and cfg.grad_regen_banks == 2


def _tiny():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    cfg = tpt.RenderConfig(width=8, height=4, spp=2, max_depth=3)
    return scene, cam, cfg, torch.zeros((4, 8, 3))


@pytest.mark.parametrize("entry", ["pixel_loss", "fit", "fit_camera"])
def test_gradient_entry_points_without_device_raise_without_cuda(entry, monkeypatch):
    scene, cam, cfg, target = _tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "fit":
            tpt.fit(scene, target, cam, cfg, tpt.make_key(0), steps=1, softness=0.0)
        elif entry == "fit_camera":
            tpt.fit_camera(scene, target, cam, cfg, tpt.make_key(0), steps=1)
        else:
            tpt.pixel_loss(tpt.split_params(scene)[0], scene, target, cam, cfg, tpt.make_key(0))


def test_grad_safe_config_routes_by_device():
    cfg = tpt.PRESETS["cover"].config
    gpu = tpt.grad_safe_config(cfg, "cuda")
    assert not gpu.use_pallas and gpu.use_pallas_grad and gpu.grad_regen
    assert gpu.spp_chunk and cfg.spp % gpu.spp_chunk == 0 and cfg.spp // gpu.spp_chunk > 1
    cpu = tpt.grad_safe_config(cfg, "cpu")
    assert not (cpu.use_pallas or cpu.use_pallas_grad or cpu.grad_regen)


def test_gradient_wrappers_on_cpu_take_plain_versions():
    scene, cam, cfg, target = _tiny()
    cfg = cfg.replace(use_pallas_grad=True, grad_regen=True, spp_chunk=1)
    wrappers = [
        (grad_regen.regen_forward, grad_regen.regen_fwd_reference),
        (grad_regen.regen_refwd, grad_regen.regen_refwd_reference),
        (grad_regen.regen_backward, grad_regen.regen_bwd_reference),
        (bucket.bucket_cols, bucket.bucket_cols_reference),
    ]
    before = [(k.launches.copy(), p.calls) for k, p in wrappers]
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
    loss = tpt.pixel_loss(params, scene, target, cam, cfg, tpt.make_key(0), device="cpu")
    loss.backward()
    for (k, p), (launches, calls) in zip(wrappers, before):
        assert k.launches == launches
        assert p.calls > calls
    call = grad_regen.regen_call(
        [t.to("meta") for t in grad_regen._trace_inputs(scene, cam, cfg)[0][:11]],
        torch.zeros(6, device="meta"), None, torch.zeros(19, device="meta"),
        tpt.make_key(0), torch.arange(4, device="meta"), n_samples=1, max_depth=3,
        width=8, height=4,
    )
    with pytest.raises(ValueError, match="unsupported device"):
        grad_regen.regen_forward(call, 0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        bucket.bucket_cols(torch.zeros((9, 4), device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"), 3)


@pytest.mark.parametrize(
    "softness,plane,want",
    [(0.0, False, "hard"), (0.0, True, "hard"), (0.02, False, "soft"), (0.02, True, "soft_plane")],
)
def test_regen_variant_names_the_kernel_instantiation(softness, plane, want):
    """The key each regen wrapper counts its launches under is the
    instantiation the CUDA entry points select (csrc/grad_regen.cu:
    variant_of): softness decides soft, then the plane decides soft_plane."""
    scene, cam, cfg, _ = _tiny()
    call = grad_regen.regen_call(
        [t.to("meta") for t in grad_regen._trace_inputs(scene, cam, cfg)[0][:11]],
        torch.zeros(6, device="meta"), None, torch.zeros(19, device="meta"),
        tpt.make_key(0), torch.arange(4, device="meta"), n_samples=1, max_depth=3,
        width=8, height=4,
    )
    assert grad_regen.variant(call._replace(softness=softness, use_plane=plane)) == want


@pytest.mark.parametrize(
    "option",
    [dict(balance=True, rebalance_every=1), dict(grad_accum=2), dict(snapshot_every=1)],
    ids=["balance", "grad_accum", "snapshot_path"],
)
def test_fit_options_run(option, tmp_path):
    """The JAX ``fit``'s options that once raised here run on the CPU:
    finite losses, the leaves moved, and the snapshot written each step."""
    scene, cam, cfg, target = _tiny()
    if "snapshot_every" in option:
        option = dict(option, snapshot_path=str(tmp_path / "fit.npz"))
    fitted, losses = tpt.fit(scene, target, cam, cfg, tpt.make_key(0), steps=2, softness=0.0,
                             leaves=("albedo",), device="cpu", **option)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not torch.equal(fitted.albedo, scene.albedo)
    if "snapshot_path" in option:
        with np.load(option["snapshot_path"]) as z:
            assert int(z["step"]) == 2 and list(z["losses"]) == losses


def test_make_accum_grad_step_runs():
    """The gradient-accumulated estimator runs on the CPU: a finite loss and a
    gradient for every leaf, the groups' sum."""
    scene, cam, cfg, target = _tiny()
    params = inverse.split_params(scene)[0]
    step = inverse.make_accum_grad_step(scene, target, cam, cfg, 2, device="cpu")
    loss, grads = step(params, tpt.make_key(0))
    assert torch.isfinite(loss) and set(grads) == set(params)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert grads["albedo"].abs().max() > 0
    with pytest.raises(ValueError, match="divide"):
        inverse.make_accum_grad_step(scene, target, cam, cfg, 3, device="cpu")


def test_fit_camera_runs_on_the_cpu():
    """``fit_camera`` (ported) runs with device='cpu' through the fused
    kernels' plain versions when the config asks for them, moves the camera
    and reports finite losses; without CUDA and without a device it
    raises."""
    scene, cam, cfg, target = _tiny()
    calls = fused.grad_bwd_reference.calls
    fitted, losses = tpt.fit_camera(scene, target, cam, cfg.replace(use_pallas_grad=True),
                                    tpt.make_key(0), steps=2, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not torch.equal(fitted.origin, cam.origin) and torch.equal(fitted.vup, cam.vup)
    assert fused.grad_bwd_reference.calls == calls + 2 * cfg.max_depth


def test_slot_map_depth_limit():
    with pytest.raises(ValueError, match="slot-map"):
        tpt.RenderConfig(max_depth=31)
    assert tpt.RenderConfig(max_depth=30).max_depth == 30
