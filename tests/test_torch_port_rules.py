"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
its entry points never fall back silently to the CPU, the kernel wrappers
take their plain versions only for CPU tensors, and paths not ported yet
raise instead of being ignored."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import inverse
from simplepathtracer_tpu_torch.ops import bucket, grad_regen, persistent
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


@pytest.mark.parametrize(
    "fields,match",
    [
        # The per-bounce fused gradient kernels (regen off) are not ported.
        (dict(use_pallas_grad=True), "use_pallas_grad"),
        (dict(use_pallas_hits=True), "use_pallas_hits"),
        # Camera gradients stay gated on the regen route too.
        (dict(use_pallas_grad=True, grad_regen=True, camera_grad=True), "camera_grad"),
        (dict(camera_grad=True), "camera_grad"),
        (dict(silhouette_softness=0.05), "silhouette_softness"),
    ],
    ids=["use_pallas_grad", "use_pallas_hits", "regen_camera_grad", "camera_grad",
         "silhouette_softness"],
)
def test_unported_config_fields_raise(fields, match):
    with pytest.raises(NotImplementedError, match=match):
        tpt.RenderConfig(**fields)


def test_regen_config_is_accepted():
    cfg = tpt.RenderConfig(use_pallas_grad=True, grad_regen=True, grad_regen_banks=2,
                           grad_regen_stream=False)
    assert cfg.grad_regen and cfg.grad_regen_banks == 2


def _tiny():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    cfg = tpt.RenderConfig(width=8, height=4, spp=2, max_depth=3)
    return scene, cam, cfg, torch.zeros((4, 8, 3))


@pytest.mark.parametrize("entry", ["pixel_loss", "fit"])
def test_gradient_entry_points_without_device_raise_without_cuda(entry, monkeypatch):
    scene, cam, cfg, target = _tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "fit":
            tpt.fit(scene, target, cam, cfg, tpt.make_key(0), steps=1, softness=0.0)
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
    before = [(k.launches, p.calls) for k, p in wrappers]
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
    "option,match",
    [
        (dict(softness=0.02), "A.11"),
        (dict(softness=0.0, balance=True), "balance"),
        (dict(softness=0.0, grad_accum=2), "grad_accum"),
        (dict(softness=0.0, snapshot_path="fit.npz"), "A.14"),
    ],
    ids=["softness", "balance", "grad_accum", "snapshot_path"],
)
def test_unported_fit_options_raise(option, match):
    scene, cam, cfg, target = _tiny()
    with pytest.raises(NotImplementedError, match=match):
        tpt.fit(scene, target, cam, cfg, tpt.make_key(0), steps=1, device="cpu", **option)


@pytest.mark.parametrize("fn", ["pixel_loss_decoupled", "make_accum_grad_step", "fit_camera"])
def test_unported_inverse_functions_raise(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(inverse, fn)()


def test_slot_map_depth_limit():
    with pytest.raises(ValueError, match="slot-map"):
        tpt.RenderConfig(max_depth=31)
    assert tpt.RenderConfig(max_depth=30).max_depth == 30
