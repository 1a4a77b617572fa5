"""The soft estimator's geometry gradient against finite differences, from
``test_torch_soft_fit.py`` (a file of its own so the suite's workers run
it beside the fits): the half-buried sphere's radius
(``tests/test_crossing.py:132-169``: 48x24, 512 spp, depth 3, soft 0.05)
on the port's eager route, AD / FD in (0.3, 1.8), the JAX package's bound
for its own estimator.
"""

import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import scenes as jscenes
from simplepathtracer_tpu.types import Material

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene


def _poke_scene():
    sc = jscenes._scene_from_lists(
        [[0.0, -0.5, 1.0], [0.9, -0.35, 1.3], [-0.85, -0.62, 0.9]],
        [0.4, 0.3, 0.35],
        [[0.1, 0.2, 0.5], [0.8, 0.6, 0.2], [0.7, 0.15, 0.15]],
        [Material.LAMBERTIAN] * 3, [0.0, 0.0, 0.0], [1.5, 1.5, 1.5],
        jscenes.SHIRLEY_SKY_LO, jscenes.SHIRLEY_SKY_HI,
    )
    return jscenes.with_ground_plane(sc)


def test_buried_radius_gradient_matches_finite_differences():
    scene = convert_scene(_poke_scene(), "cpu")
    cam = convert_camera(spt.make_camera(origin=(0.0, 0.5, -1.2), lookat=(0.0, -0.35, 1.0),
                                         vfov_deg=55), "cpu")
    # spp_chunk bounds the autograd memory; it changes no sample.
    cfg = tpt.RenderConfig(width=48, height=24, spp=512, max_depth=3, spp_chunk=128,
                           silhouette_softness=0.05)
    prng = np.random.default_rng(11)
    pert = scene.replace(
        centers=scene.centers + torch.tensor(0.04 * prng.standard_normal((3, 3)),
                                             dtype=torch.float32),
        radii=scene.radii * torch.tensor(1.0 + 0.05 * prng.standard_normal(3),
                                         dtype=torch.float32),
    )
    with torch.no_grad():
        target = tpt.render_linear(pert, cam, cfg, tpt.make_key(99))
    params, _ = tpt.split_params(scene)

    def loss(radii):
        return tpt.pixel_loss(dict(params, radii=radii), scene, target, cam, cfg,
                              tpt.make_key(7), device="cpu")

    r = params["radii"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(r), [r])
    eps = 4e-3
    v = torch.tensor([1.0, 0.0, 0.0])
    with torch.no_grad():
        fd = (loss(r + eps * v).item() - loss(r - eps * v).item()) / (2 * eps)
    ad = g[0].item()
    assert fd != 0.0
    assert 0.3 < ad / fd < 1.8, (ad, fd, ad / fd)
