"""Core data types of the PyTorch port: scene, camera, config, state.

Counterpart of ``simplepathtracer_tpu/types.py``.  Field names and defaults
are the same, so a scene or config maps one to one between the packages.
``Scene``, ``Camera`` and ``RenderState`` are frozen dataclasses of tensors;
every tensor of one scene or camera lies on one device, and the render runs
where they lie.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Material(enum.IntEnum):
    """Surface material ids (same values as the JAX package)."""

    LAMBERTIAN = 0
    METAL = 1
    DIELECTRIC = 2


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Without a device and without CUDA this raises: the port
    never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA sphere scene (see the JAX package's ``Scene`` for the meaning of
    each leaf).  ``radii`` may be negative (hollow glass).  ``plane`` is
    None or f32[7]: unit normal xyz, offset k (surface dot(n, p) + k = 0),
    albedo rgb.  ``emission`` is None or f32[S, 3], the radiance each
    sphere emits: a hit adds the path's throughput times it, before the
    hit's scatter (the plane emits nothing).  The JAX package has no such
    leaf; only the persistent route carries it (``routes.CAPS``)."""

    centers: torch.Tensor   # [S, 3] f32
    radii: torch.Tensor     # [S] f32
    albedo: torch.Tensor    # [S, 3] f32
    material: torch.Tensor  # [S] i32
    fuzz: torch.Tensor      # [S] f32
    ior: torch.Tensor       # [S] f32
    sky_lo: torch.Tensor    # [3] f32
    sky_hi: torch.Tensor    # [3] f32
    plane: torch.Tensor | None = None
    emission: torch.Tensor | None = None

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def emitters(self) -> int:
        """Spheres whose emission has a non-zero entry (0 without an
        emission table; see ``nonzero_rows``)."""
        return 0 if self.emission is None else nonzero_rows(self.emission)

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


def nonzero_rows(table: torch.Tensor) -> int:
    """Rows of ``table`` with a non-zero entry.  The count is read back from
    the table's device once for each version of the tensor and kept on it,
    so a render loop over one scene does not wait on the device for it
    again (an in-place change of the table is read anew)."""
    seen = getattr(table, "_spt_nonzero_rows", None)
    if seen is None or seen[0] != table._version:
        seen = (table._version, int(torch.count_nonzero(table.ne(0).any(-1))))
        table._spt_nonzero_rows = seen
    return seen[1]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Thin-lens camera (pinhole when aperture == 0); 0-d f32 scalars."""

    origin: torch.Tensor      # [3]
    lookat: torch.Tensor      # [3]
    vup: torch.Tensor         # [3]
    vfov_deg: torch.Tensor    # []
    aperture: torch.Tensor    # []
    focus_dist: torch.Tensor  # []

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def make_camera(
    origin=(0.0, 1.0, -3.0),
    lookat=(0.0, 1.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    vfov_deg=90.0,
    aperture=0.0,
    focus_dist=None,
    device=None,
) -> Camera:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    origin, lookat = f32(origin), f32(lookat)
    if focus_dist is None:
        focus_dist = torch.linalg.norm(lookat - origin)
    return Camera(
        origin=origin, lookat=lookat, vup=f32(vup), vfov_deg=f32(vfov_deg),
        aperture=f32(aperture), focus_dist=f32(focus_dist),
    )


# Fields of paths this port does not have yet, with their defaults.  Setting
# one away from its default raises instead of being ignored.
_NOT_PORTED = {
    "rng_impl": "threefry2x32",
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration; the JAX package's fields and defaults.

    The kernel flags (``use_pallas``, ``use_pallas_hits``,
    ``use_pallas_grad``, ``grad_regen``, ``grad_regen_stream``,
    ``camera_grad``) keep their meanings; ``routes.pick`` turns them into
    the route a call takes (``routes.py``).  ``grad_regen_banks``: pixel
    banks per lane of the regeneration kernels (0 = ``GPU_BANKS``).  The
    JAX package's ``pallas_interpret`` has no counterpart: the tensors'
    device picks the kernel or its plain version.
    """

    width: int = 1440
    height: int = 1440
    spp: int = 100
    max_depth: int = 10
    t_min: float = 1e-3
    t_max: float = 3.0e7
    gamma: float = 2.0
    spp_chunk: int = 0
    use_pallas: bool = False
    use_pallas_hits: bool = False
    use_pallas_grad: bool = False
    grad_regen: bool = False
    grad_regen_banks: int = 0
    grad_regen_stream: bool = True
    camera_grad: bool = False
    silhouette_softness: float = 0.0
    rr_start_depth: int = 0
    balance_probe_spp: int = 0
    rng_impl: str = "threefry2x32"

    def __post_init__(self):
        # Bounce b uses RNG slots 4b..4b+3 and the camera 124/125
        # (ops/sampling.py): a deeper path would reuse the camera slots.
        if self.max_depth > 30:
            raise ValueError(
                f"max_depth={self.max_depth} exceeds 30, the RNG slot-map "
                "limit (bounce b uses slots 4b..4b+3; camera uses 124/125 — "
                "see ops/sampling.py)"
            )
        for name, default in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"RenderConfig.{name}={getattr(self, name)!r}: this path "
                    "is not ported to PyTorch yet (default "
                    f"{default!r})"
                )

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Progressive accumulation state: linear radiance sum, the number of
    samples in it, and the key of the render."""

    accum: torch.Tensor   # [H, W, 3] f32
    sample_count: int
    next_key: torch.Tensor  # [2] i64 holding two u32 words

    def image(self, gamma: float = 2.0) -> torch.Tensor:
        """Gamma-corrected float image in [0, 1]."""
        n = float(max(self.sample_count, 1))
        linear = torch.clamp(self.accum / n, 0.0, 1.0)
        return linear ** (1.0 / gamma)

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)


