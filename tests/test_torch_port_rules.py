"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
its entry points never fall back silently to the CPU, the kernel wrapper
takes its plain version only for CPU tensors, and paths not ported yet
raise instead of being ignored."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import persistent
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
    "field,value",
    [
        ("use_pallas_grad", True),
        ("use_pallas_hits", True),
        ("grad_regen", True),
        ("camera_grad", True),
        ("silhouette_softness", 0.05),
    ],
)
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        tpt.RenderConfig(**{field: value})


def test_slot_map_depth_limit():
    with pytest.raises(ValueError, match="slot-map"):
        tpt.RenderConfig(max_depth=31)
    assert tpt.RenderConfig(max_depth=30).max_depth == 30
