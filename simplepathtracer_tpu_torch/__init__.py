"""simplepathtracer_tpu_torch — the PyTorch / CUDA port of simplepathtracer_tpu.

The forward render of every preset runs on an NVIDIA Hopper card through a
hand-written CUDA kernel (``csrc/persistent.cu``), and inverse rendering
(``fit``, ``pixel_loss``) through the hand-written regeneration gradient
kernels (``csrc/grad_regen.cu``, ``csrc/bucket.cu``), all built with nvcc
at first use; on CPU tensors the same functions run as plain PyTorch.  Entry points
that create tensors run on ``cuda`` unless the caller passes ``device``.
"""

from .types import Camera, Material, RenderConfig, RenderState, Scene, make_camera
from .scenes import (
    SCENES,
    compact_scene,
    cover_scene,
    random_scene,
    reference_scene,
    simple_scene,
    three_sphere_scene,
    with_ground_plane,
)
from .ops.sampling import fold_in, make_key
from .render import (
    accumulate,
    grad_safe_config,
    init_state,
    render,
    render_pixels,
    trace_rays,
)
from .inverse import fit, merge_params, pixel_loss, render_linear, split_params
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
    "three_sphere_scene",
    "with_ground_plane",
    "accumulate",
    "init_state",
    "render",
    "render_pixels",
    "trace_rays",
    "grad_safe_config",
    "fit",
    "pixel_loss",
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
