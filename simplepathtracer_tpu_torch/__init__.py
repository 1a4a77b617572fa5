"""simplepathtracer_tpu_torch — the PyTorch / CUDA port of simplepathtracer_tpu.

Renders (``render``, ``accumulate``, ``render_pixels``, ``trace_rays``),
inverse rendering (``fit``, ``pixel_loss``; soft silhouettes included) and
camera fits (``fit_camera``) run on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``, built with nvcc at first use); on CPU
tensors the same functions run as plain PyTorch.  Which route -- which
kernels -- a call takes, and what each route carries, is decided in one
place: ``routes.py`` (``routes.pick``, ``routes.CAPS``).
Entry points that create tensors run on ``cuda`` unless the caller passes
``device``.  The command line (``python -m simplepathtracer_tpu_torch.cli``)
renders and fits presets, with render snapshots (``checkpoint``), fit
snapshots, a live HTTP preview (``preview``) and JSON-line metrics
(``metrics``).  ``tracing`` marks the layers' phases with spans (recorded
while a ``torch.profiler`` profile runs) and counts kernel launches.
``parallel`` splits renders, gradients and fits (``inverse.fit_sharded``)
over a (tiles, samples) mesh of processes on ``torch.distributed``, one
device each.
"""

from . import routes, tracing  # routes first: ops modules import it back
from .types import Camera, Material, RenderConfig, RenderState, Scene, make_camera
from .scenes import (
    SCENES,
    compact_scene,
    cover_scene,
    random_scene,
    reference_scene,
    simple_scene,
    smallpt_scene,
    three_sphere_scene,
    with_ground_plane,
)
from .ops.sampling import fold_in, make_key
from .render import (
    accumulate,
    balanced_pixel_perm,
    init_state,
    render,
    render_pixels,
    trace_rays,
)
from .routes import grad_safe_config
from .inverse import (
    CAMERA_LEAVES,
    camera_pixel_loss,
    fit,
    fit_camera,
    make_accum_grad_step,
    merge_camera,
    merge_params,
    pixel_loss,
    pixel_loss_decoupled,
    render_linear,
    split_camera,
    split_params,
)
from .presets import PRESETS, Preset
from .convert import convert_camera, convert_params, convert_scene, params_to_numpy

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Material",
    "RenderConfig",
    "RenderState",
    "Scene",
    "make_camera",
    "make_key",
    "fold_in",
    "SCENES",
    "compact_scene",
    "cover_scene",
    "random_scene",
    "reference_scene",
    "simple_scene",
    "smallpt_scene",
    "three_sphere_scene",
    "with_ground_plane",
    "accumulate",
    "init_state",
    "render",
    "render_pixels",
    "trace_rays",
    "grad_safe_config",
    "balanced_pixel_perm",
    "fit",
    "make_accum_grad_step",
    "fit_camera",
    "camera_pixel_loss",
    "CAMERA_LEAVES",
    "split_camera",
    "merge_camera",
    "pixel_loss",
    "pixel_loss_decoupled",
    "render_linear",
    "split_params",
    "merge_params",
    "PRESETS",
    "Preset",
    "convert_camera",
    "convert_scene",
    "convert_params",
    "params_to_numpy",
]
