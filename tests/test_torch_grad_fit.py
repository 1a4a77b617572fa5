"""``fit`` of the port against the JAX package's: the gradient slice as a
whole.

Three Adam steps on the regen route (the JAX package in Pallas interpret
mode, the port through the regeneration kernels' plain versions on the
CPU), 16x8 px, 4 spp, depth 4, albedo and sky fitted, soft silhouettes
off.  Step keys are ``fold_in(key, i)`` in both.  Bounds: losses rtol 1e-5,
fitted leaves atol 1e-5 (Adam in torch and optax round its update in
another order; the gradients agree to ``test_torch_grad_route``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse as jinv

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import (
    convert_camera,
    convert_params,
    convert_scene,
    params_to_numpy,
)

LEAVES = ("albedo", "sky_lo", "sky_hi")
STEPS, LR = 3, 2e-2


@pytest.fixture(scope="module")
def fits():
    scene = spt.three_sphere_scene(hollow_glass=False)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=4)
    key = jax.random.PRNGKey(2)
    target = np.asarray(jinv.render_linear(scene, cam, cfg, jax.random.fold_in(key, 9)))
    start = scene.replace(
        albedo=jnp.clip(scene.albedo * 0.6, 0.05, 0.95), sky_lo=scene.sky_lo * 0.8,
        sky_hi=scene.sky_hi * 0.8,
    )
    j_scene, j_losses = jinv.fit(
        start, jnp.asarray(target), cam,
        cfg.replace(use_pallas_grad=True, grad_regen=True, pallas_interpret=True), key,
        steps=STEPS, lr=LR, leaves=LEAVES, softness=0.0,
    )
    t_cfg = tpt.RenderConfig(width=16, height=8, spp=4, max_depth=4,
                             use_pallas_grad=True, grad_regen=True)
    t_scene, t_losses = tpt.fit(
        convert_scene(start, "cpu"), torch.tensor(target), convert_camera(cam, "cpu"), t_cfg,
        tpt.make_key(2), steps=STEPS, lr=LR, leaves=LEAVES, softness=0.0, device="cpu",
    )
    j_params = {k: np.asarray(getattr(j_scene, k)) for k in LEAVES}
    t_params = params_to_numpy({k: getattr(t_scene, k) for k in LEAVES})
    return j_losses, t_losses, j_params, t_params, start


def test_fit_matches_jax(fits):
    j_losses, t_losses, j_params, t_params, _ = fits
    assert len(t_losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_losses, [float(x) for x in j_losses], rtol=1e-5)
    for k in LEAVES:
        np.testing.assert_allclose(t_params[k], j_params[k], atol=1e-5, rtol=0, err_msg=k)


def test_fit_moves_toward_the_target(fits):
    _, t_losses, _, t_params, start = fits
    assert t_losses[-1] < t_losses[0]
    moved = convert_params({k: np.asarray(getattr(start, k)) for k in LEAVES}, "cpu")
    for k in LEAVES:
        assert np.abs(t_params[k] - moved[k].numpy()).max() > 0.0, k
