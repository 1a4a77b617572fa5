"""Snapshot / resume for progressive renders (counterpart of the JAX
package's ``checkpoint.py``).

The snapshot is the ``RenderState`` (radiance sum, sample count, key) with
the scene, the whole config and optionally the camera, in the JAX
package's ``.npz`` format, version 3: ``accum`` f32 [H, W, 3],
``sample_count``, ``next_key`` as two u32 words, ``config_json`` (every
config field), ``scene_*`` and ``camera_*``.  A snapshot written by either
package loads in the other; each ignores config fields it lacks (the JAX
package's ``pallas_interpret`` here).  An emissive scene's snapshot also
holds ``scene_emission`` (f32 [S, 3]), which only this package reads.  Sample ids continue from the
snapshot's count, so a resumed render is bit-identical to an uninterrupted
one with the same chunks.

``save_sharded`` / ``load_sharded`` snapshot a render split over a
``parallel`` mesh: each process writes only its tile's rows to
``{prefix}.proc{rank}of{world}.npz`` (the JAX package's sharded format,
version 3: ``row_start``, ``row_size``, ``num_pixels``, ``mesh_tiles``,
``mesh_samples``, ``accum_rows``, ``sample_count``, ``next_key``,
``config_json``, ``scene_*``, ``camera_*``) and reads only its own file
back.  At world size 1 a sharded snapshot of either package loads in the
other.
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
        "accum": _np(state.accum).astype(np.float32),
        **_payload(state.sample_count, state.next_key, scene, config, camera),
    }
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
            next_key=_key(z),
        )
        scene, camera = _scene_camera(z, t)
    return state, scene, config, camera


def _key(z):
    """The snapshot's key as the port keeps it (two words, int64, CPU)."""
    return torch.as_tensor(np.asarray(z["next_key"]).astype(np.int64))


def _scene_camera(z, t):
    """(scene, camera or None) of an open snapshot; ``t(name, dtype)``
    reads an entry as a tensor on the load's device."""
    scene = Scene(
        **{f: t(f"scene_{f}", np.int32 if f == "material" else np.float32)
           for f in _SCENE_FIELDS},
        plane=t("scene_plane", np.float32) if "scene_plane" in z else None,
        emission=t("scene_emission", np.float32) if "scene_emission" in z else None,
    )
    camera = None
    if f"camera_{_CAMERA_FIELDS[0]}" in z:
        camera = Camera(**{f: t(f"camera_{f}", np.float32) for f in _CAMERA_FIELDS})
    return scene, camera


def _payload(sample_count, key, scene, config, camera):
    """The entries every snapshot carries beside its radiance sums."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "sample_count": np.int64(int(sample_count)),
        "next_key": (_np(key).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32),
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), np.uint8
        ),
    }
    for f in _SCENE_FIELDS:
        payload[f"scene_{f}"] = _np(getattr(scene, f))
    if scene.plane is not None:
        payload["scene_plane"] = _np(scene.plane)
    if scene.emission is not None:
        payload["scene_emission"] = _np(scene.emission).astype(np.float32)
    if camera is not None:
        for f in _CAMERA_FIELDS:
            payload[f"camera_{f}"] = _np(getattr(camera, f))
    return payload


def _shard_path(prefix: str) -> str:
    import torch.distributed as dist

    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return f"{prefix}.proc{rank}of{world}.npz"


def save_sharded(
    prefix: str, acc, sample_count: int, key, scene: Scene, config: RenderConfig, mesh,
    camera: Camera | None = None,
) -> str:
    """Atomically write this process's snapshot of a tile-split render to
    ``{prefix}.proc{rank}of{world}.npz``; returns the path.

    ``acc``: this process's [P / tiles, 3] rows of radiance sums (what
    ``parallel.render_accum_sharded`` returns), ``sample_count`` the
    samples they hold.  Only this process's rows are written (no gather):
    a snapshot costs each process its tile.  The key, scene, config and
    camera are replicated and small, so every file carries them."""
    from .parallel.distributed import local_tile_slice
    from .parallel.sharding import mesh_shape

    start, size = local_tile_slice(mesh, config.num_pixels)
    if tuple(acc.shape) != (size, 3):
        raise ValueError(f"acc holds {tuple(acc.shape)} rows; this process's tile is [{size}, 3]")
    shape = mesh_shape(mesh)
    payload = {
        "row_start": np.int64(start),
        "row_size": np.int64(size),
        "num_pixels": np.int64(config.num_pixels),
        "mesh_tiles": np.int64(shape["tiles"]),
        "mesh_samples": np.int64(shape["samples"]),
        "accum_rows": _np(acc).astype(np.float32),
        **_payload(sample_count, key, scene, config, camera),
    }
    return atomic_savez(_shard_path(prefix), payload)


def load_sharded(prefix: str, mesh, device=None):
    """Read this process's file of a sharded snapshot ->
    (acc rows [P / tiles, 3], sample_count, key, scene, config, camera or
    None), the tensors on ``device`` (CUDA unless named; the key on the
    CPU).  Raises ``ValueError`` on another format version, a mesh of
    another shape, or rows that are not this process's tile.  Resume:
    ``acc + render_accum_sharded(..., sample_offset=sample_count,
    n_samples=more)`` sums the samples of an uninterrupted run."""
    from .parallel.distributed import local_tile_slice
    from .parallel.sharding import mesh_shape

    dev = resolve_device(device)
    path = _shard_path(prefix)
    shape = mesh_shape(mesh)
    with np.load(path) as z:
        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported sharded snapshot version {version} in {path!r} "
                f"(expected {_FORMAT_VERSION})"
            )
        if (int(z["mesh_tiles"]), int(z["mesh_samples"])) != (shape["tiles"], shape["samples"]):
            raise ValueError(
                f"snapshot mesh {int(z['mesh_tiles'])}x{int(z['mesh_samples'])} "
                f"does not match the restore mesh {shape['tiles']}x{shape['samples']} ({path!r})"
            )
        cfg = json.loads(bytes(z["config_json"].tobytes()).decode())
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        config = RenderConfig(**{k: v for k, v in cfg.items() if k in known})
        start, size = local_tile_slice(mesh, config.num_pixels)
        if (int(z["row_start"]), int(z["row_size"])) != (start, size):
            raise ValueError(
                f"snapshot rows [{int(z['row_start'])}, +{int(z['row_size'])}) "
                f"do not match this process's tile slice [{start}, +{size}) -- "
                f"was the snapshot written by a different process layout? ({path!r})"
            )

        def t(name, dtype):
            return torch.as_tensor(np.asarray(z[name], dtype), device=dev)

        acc = t("accum_rows", np.float32)
        scene, camera = _scene_camera(z, t)
        sample_count, key = int(z["sample_count"]), _key(z)
    return acc, sample_count, key, scene, config, camera
