"""Named render presets (counterpart of the JAX package's ``presets.py``):
the same seven (scene factory, camera, RenderConfig) triples, and the
port's own ``smallpt`` (an emissive scene, which the JAX package cannot
render)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from . import scenes
from .types import Camera, RenderConfig, Scene, make_camera, resolve_device


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    scene_fn: Callable[..., Scene]     # (seed, device) -> Scene
    camera_fn: Callable[..., Camera]   # (device) -> Camera
    config: RenderConfig

    def build(self, seed: int = 0, device=None):
        """(scene, camera, config) on ``device`` (CUDA unless named)."""
        device = resolve_device(device)
        return self.scene_fn(seed, device), self.camera_fn(device), self.config


def _cover_camera(device):
    return make_camera(
        origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20,
        aperture=0.1, focus_dist=10.0, device=device,
    )


def _smallpt_camera(device):
    """smallpt's pinhole: at (50, 52, 295.6) along normalise(0, -0.042612,
    -1), its image plane spanning cx = w * .5135 / h across and .5135 up
    per unit of the view direction, so vfov = 2 atan(.5135 / 2)."""
    origin = (50.0, 52.0, 295.6)
    n = math.sqrt(0.042612 ** 2 + 1.0)
    look = (origin[0], origin[1] - 0.042612 / n, origin[2] - 1.0 / n)
    return make_camera(origin=origin, lookat=look, vfov_deg=math.degrees(2 * math.atan(0.5135 / 2)),
                       device=device)


def _cover(seed, device):
    return scenes.compact_scene(scenes.cover_scene(seed, max_spheres=512, device=device))


# The least ray offset at which f32 rays leaving smallpt's 1e5-radius walls
# do not find the wall they left (PERF.md, the smallpt configuration).
SMALLPT_T_MIN = 0.1

PRESETS = {
    "simple": Preset(
        name="simple",
        description="Single Lambertian sphere + ground, 200x100 @ 16spp depth 8",
        scene_fn=lambda seed, device: scenes.simple_scene(device=device),
        camera_fn=lambda device: make_camera(
            origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device=device),
        config=RenderConfig(width=200, height=100, spp=16, max_depth=8,
                            use_pallas=True),
    ),
    "three_sphere": Preset(
        name="three_sphere",
        description="Lambertian/metal/hollow-glass trio, 400x200 @ 64spp",
        scene_fn=lambda seed, device: scenes.three_sphere_scene(
            hollow_glass=True, device=device),
        camera_fn=lambda device: make_camera(
            origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device=device),
        config=RenderConfig(width=400, height=200, spp=64, max_depth=10,
                            use_pallas=True),
    ),
    "cover": Preset(
        name="cover",
        description="Shirley cover scene (~490 spheres), 1200x800 @ 100spp, defocus",
        scene_fn=_cover,
        camera_fn=_cover_camera,
        config=RenderConfig(width=1200, height=800, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    "three_sphere_plane": Preset(
        name="three_sphere_plane",
        description="Lambertian/metal/glass trio on an INFINITE plane, 400x200 @ 64spp",
        scene_fn=lambda seed, device: scenes.with_ground_plane(
            scenes.three_sphere_scene(hollow_glass=True, device=device)),
        camera_fn=lambda device: make_camera(
            origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device=device),
        config=RenderConfig(width=400, height=200, spp=64, max_depth=10,
                            use_pallas=True),
    ),
    "reference": Preset(
        name="reference",
        description="The reference's hard-coded 3x3 grid scene (InitSpheres)",
        scene_fn=lambda seed, device: scenes.reference_scene(device=device),
        camera_fn=lambda device: make_camera(
            origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=device),
        config=RenderConfig(width=1440, height=1440, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    "random": Preset(
        name="random",
        description="The reference's randomized lattice scene (GenerateSpheres)",
        scene_fn=lambda seed, device: scenes.compact_scene(
            scenes.random_scene(seed, max_spheres=512, device=device)),
        camera_fn=lambda device: make_camera(
            origin=(0, 4, -10), lookat=(0, 2, 5), vfov_deg=60, device=device),
        config=RenderConfig(width=1440, height=1440, spp=100, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    "cover_multihost": Preset(
        name="cover_multihost",
        description="Cover scene 1200x800 @ 2000spp for sharded multi-chip runs",
        scene_fn=_cover,
        camera_fn=_cover_camera,
        config=RenderConfig(width=1200, height=800, spp=2000, max_depth=10,
                            spp_chunk=0, use_pallas=True),
    ),
    "smallpt": Preset(
        name="smallpt",
        description="smallpt's Cornell box lit by its emissive ceiling sphere, 1024x768 @ 256spp",
        scene_fn=lambda seed, device: scenes.smallpt_scene(device=device),
        camera_fn=_smallpt_camera,
        config=RenderConfig(width=1024, height=768, spp=256, max_depth=30, t_min=SMALLPT_T_MIN,
                            gamma=2.2, rr_start_depth=5, use_pallas=True),
    ),
}
