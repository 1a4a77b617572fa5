"""Scene and camera converter: the JAX package's leaves -> the port's.

The sphere tables are this system's weights.  ``convert_scene`` and
``convert_camera`` take any object (or mapping) holding the JAX package's
leaf names, as numpy arrays or anything ``np.asarray`` accepts, and build
the port's ``Scene`` / ``Camera`` in float32 / int32 on a device.  So both
packages can render identical tables.  ``convert_params`` and
``params_to_numpy`` carry a fit's params (or gradients) dict across and
back.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import Camera, Scene, resolve_device

SCENE_LEAVES = ("centers", "radii", "albedo", "material", "fuzz", "ior",
                "sky_lo", "sky_hi")
CAMERA_LEAVES = ("origin", "lookat", "vup", "vfov_deg", "aperture", "focus_dist")


def _leaf(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def convert_scene(src, device=None) -> Scene:
    """Port ``Scene`` from the leaves centers, radii, albedo, material, fuzz,
    ior, sky_lo, sky_hi and the optional plane."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x, dtype=dtype), device=device)

    leaves = {
        name: t(_leaf(src, name), np.int32 if name == "material" else np.float32)
        for name in SCENE_LEAVES
    }
    plane = src.get("plane") if isinstance(src, dict) else getattr(src, "plane", None)
    return Scene(**leaves, plane=None if plane is None else t(plane, np.float32))


def convert_camera(src, device=None) -> Camera:
    """Port ``Camera`` from the leaves origin, lookat, vup, vfov_deg,
    aperture and focus_dist."""
    device = resolve_device(device)
    return Camera(**{
        name: torch.as_tensor(np.array(_leaf(src, name), dtype=np.float32), device=device)
        for name in CAMERA_LEAVES
    })


def convert_params(params, device=None) -> dict:
    """A params dict of the JAX package's ``inverse.split_params`` (leaf
    name -> array) as the port's: float32 tensors on ``device``."""
    device = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in params.items() if v is not None
    }


def params_to_numpy(params) -> dict:
    """A port params (or gradients) dict as numpy float32 arrays, for
    comparing with the JAX package's."""
    return {
        k: np.asarray(v.detach().cpu().numpy(), dtype=np.float32)
        for k, v in params.items() if v is not None
    }
