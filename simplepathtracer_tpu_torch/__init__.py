"""simplepathtracer_tpu_torch — the PyTorch / CUDA port of simplepathtracer_tpu.

The forward render of every preset runs on an NVIDIA Hopper card through one
hand-written CUDA kernel (``csrc/persistent.cu``, built with nvcc at first
use); on CPU tensors the same functions run as plain PyTorch.  Entry points
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
from .ops.sampling import make_key
from .render import accumulate, init_state, render, render_pixels, trace_rays
from .presets import PRESETS, Preset
from .convert import convert_camera, convert_scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Material",
    "RenderConfig",
    "RenderState",
    "Scene",
    "make_camera",
    "make_key",
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
    "PRESETS",
    "Preset",
    "convert_camera",
    "convert_scene",
]
