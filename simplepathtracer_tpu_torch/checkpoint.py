"""Snapshot / resume for progressive renders (counterpart of the JAX
package's ``checkpoint.py``).

The snapshot is the ``RenderState`` (radiance sum, sample count, key) with
the scene, the whole config and optionally the camera, in the JAX
package's ``.npz`` format, version 3: ``accum`` f32 [H, W, 3],
``sample_count``, ``next_key`` as two u32 words, ``config_json`` (every
config field), ``scene_*`` and ``camera_*``.  A snapshot written by either
package loads in the other; each ignores config fields it lacks (the JAX
package's ``pallas_interpret`` here).  Sample ids continue from the
snapshot's count, so a resumed render is bit-identical to an uninterrupted
one with the same chunks.

``save_sharded`` / ``load_sharded`` (multi-device renders) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from .types import Camera, RenderConfig, RenderState, Scene, resolve_device

_FORMAT_VERSION = 3

_SCENE_FIELDS = (
    "centers", "radii", "albedo", "material", "fuzz", "ior", "sky_lo", "sky_hi"
)
_CAMERA_FIELDS = ("origin", "lookat", "vup", "vfov_deg", "aperture", "focus_dist")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def atomic_savez(path: str, payload: dict) -> str:
    """Write ``payload`` as an ``.npz`` at ``path`` through a temporary file
    in the same directory and ``os.replace``: a reader never sees a partial
    file, and a crash leaves the old one."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def save(
    path: str, state: RenderState, scene: Scene, config: RenderConfig,
    camera: Camera | None = None,
) -> str:
    """Atomically write a snapshot; returns ``path``."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "accum": _np(state.accum).astype(np.float32),
        "sample_count": np.int64(int(state.sample_count)),
        "next_key": (_np(state.next_key).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32),
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), np.uint8
        ),
    }
    for f in _SCENE_FIELDS:
        payload[f"scene_{f}"] = _np(getattr(scene, f))
    if scene.plane is not None:
        payload["scene_plane"] = _np(scene.plane)
    if camera is not None:
        for f in _CAMERA_FIELDS:
            payload[f"camera_{f}"] = _np(getattr(camera, f))
    return atomic_savez(path, payload)


def load(path: str, device=None):
    """Read a snapshot -> (RenderState, Scene, RenderConfig, Camera | None)
    with the tensors on ``device`` (CUDA unless named; the key stays on the
    CPU, as ``init_state`` keeps it).  The camera is None for a snapshot
    written without one."""
    dev = resolve_device(device)
    with np.load(path) as z:
        version = int(z["version"])
        if not 1 <= version <= _FORMAT_VERSION:
            raise ValueError(f"unknown snapshot version {version} in {path!r}")
        cfg = json.loads(bytes(z["config_json"].tobytes()).decode())
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        config = RenderConfig(**{k: v for k, v in cfg.items() if k in known})

        def t(name, dtype):
            return torch.as_tensor(np.asarray(z[name], dtype), device=dev)

        state = RenderState(
            accum=t("accum", np.float32),
            sample_count=int(z["sample_count"]),
            next_key=torch.as_tensor(np.asarray(z["next_key"]).astype(np.int64)),
        )
        scene = Scene(
            **{f: t(f"scene_{f}", np.int32 if f == "material" else np.float32)
               for f in _SCENE_FIELDS},
            plane=t("scene_plane", np.float32) if "scene_plane" in z else None,
        )
        camera = None
        if f"camera_{_CAMERA_FIELDS[0]}" in z:
            camera = Camera(**{f: t(f"camera_{f}", np.float32) for f in _CAMERA_FIELDS})
    return state, scene, config, camera
