"""Ray-tracing operators of the PyTorch port: sampling, intersection,
plane, materials and the kernels' host sides."""

from .intersect import Hit, intersect_scene, intersect_scene_pallas  # noqa: F401
