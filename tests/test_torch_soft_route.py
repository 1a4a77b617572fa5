"""Soft-silhouette ``pixel_loss`` gradients of the port against the JAX
package, end to end, and ``pixel_loss_decoupled``.

* The eager route (plain autograd through ``trace_rays``' soft branch)
  against ``jax.grad`` through the JAX jnp path.
* The regen route (``use_pallas_grad=True, grad_regen=True``: on the CPU
  the regeneration kernels' plain versions) against the JAX regen route in
  Pallas interpret mode (``test_torch_soft_regen_route.py``, which reuses
  this file's checks).
* ``pixel_loss_decoupled``'s value against the JAX package's, and its
  gradient against the independent-pair estimator written out.

Cases: sphere-only, soft 0.05 (16x8 px, 4 spp, depth 4); ground plane, soft
0.05, Russian roulette from bounce 2 (the crossing coin live).  The eager
plane case is ``test_torch_soft_route_plane.py``: one heavy case per file,
so the suite's workers run them at once.

Bounds: the JAX package's own for its soft regen route against its jnp
path -- rtol 2e-3, atol 2e-6 per leaf sphere-only
(``tests/test_pallas_grad_regen.py:437-440``), relative L2 < 0.05 per leaf
with the plane (``:615-621``); losses rtol 1e-6.  Both sides are taken on
the same pixels: those whose radiance the two packages render within 1e-5
(every channel).  The others hold a path that took another turn on a
knife edge -- the camera rays already differ by an ulp between XLA and
PyTorch, and a soft path has knife edges a hard one lacks (a phantom
winner faces the ray or not by the last bit of d . n) -- and one such path
moves its pixel's gradient by O(1).  At most 2% of pixels may be left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse as jinv
from simplepathtracer_tpu.scenes import with_ground_plane

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy

CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
SOFT = 0.05
MAX_LEFT_OUT = 0.02


def _setup(plane):
    scene = spt.three_sphere_scene(hollow_glass=False)
    cfg = dict(width=16, height=8, spp=4, max_depth=4, silhouette_softness=SOFT)
    seed = 2
    if plane:
        scene = with_ground_plane(scene)
        scene = scene.replace(plane=jnp.asarray(scene.plane).at[3].set(0.6))
        cfg["rr_start_depth"] = 2
        seed = 7
    return scene, spt.make_camera(**CAM), cfg, seed


def _jax_cfg(cfg, regen):
    c = spt.RenderConfig(**cfg)
    if regen:
        c = c.replace(use_pallas_grad=True, grad_regen=True, pallas_interpret=True)
    return c


def _port_cfg(cfg, regen):
    c = tpt.RenderConfig(**cfg)
    return c.replace(use_pallas_grad=True, grad_regen=True) if regen else c


def _kept_pixels(scene, cam, cfg, seed, regen):
    """Pixel ids whose radiance the two packages render within 1e-5."""
    img_j = np.asarray(jinv.render_linear(scene, cam, _jax_cfg(cfg, regen),
                                          jax.random.PRNGKey(seed)))
    c = tpt.grad_safe_config(_port_cfg(cfg, regen), "cpu")
    img_t = tpt.render_linear(convert_scene(scene, "cpu"), convert_camera(cam, "cpu"), c,
                              tpt.make_key(seed)).numpy()
    ok = (np.abs(img_j - img_t) <= 1e-5).all(axis=-1).reshape(-1)
    assert (~ok).mean() <= MAX_LEFT_OUT, (~ok).sum()
    return np.nonzero(ok)[0]


def _jax_grads(scene, cam, cfg, seed, regen, perm, loss=jinv.pixel_loss):
    c = _jax_cfg(cfg, regen)
    target = jnp.full((c.height, c.width, 3), 0.25, jnp.float32)
    params, static = jinv.split_params(scene)
    l, g = jax.value_and_grad(loss)(params, static, target, cam, c, jax.random.PRNGKey(seed),
                                    jinv.DIFF_LEAVES, jnp.asarray(perm, jnp.int32))
    return float(l), {k: np.asarray(v) for k, v in g.items()}


def _port_grads(scene, cam, cfg, seed, regen, perm, loss=tpt.pixel_loss):
    c = _port_cfg(cfg, regen)
    params, static = tpt.split_params(convert_scene(scene, "cpu"))
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    target = torch.full((c.height, c.width, 3), 0.25)
    l = loss(params, static, target, convert_camera(cam, "cpu"), c, tpt.make_key(seed),
             pixel_perm=torch.as_tensor(perm), device="cpu")
    g = torch.autograd.grad(l, list(params.values()))
    return l.item(), params_to_numpy(dict(zip(params, g)))


def _assert_soft_grads_match(got, want, plane):
    assert set(got) == set(want)
    for k in want:
        if plane:
            err = np.linalg.norm(got[k] - want[k]) / (np.linalg.norm(want[k]) + 1e-12)
            assert err < 0.05 or np.linalg.norm(got[k] - want[k]) < 1e-4, (k, err)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-6, err_msg=k)


def check_soft_gradients(plane, regen):
    scene, cam, cfg, seed = _setup(plane)
    perm = _kept_pixels(scene, cam, cfg, seed, regen)
    l_j, g_j = _jax_grads(scene, cam, cfg, seed, regen, perm)
    l_t, g_t = _port_grads(scene, cam, cfg, seed, regen, perm)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    # Geometry leaves receive silhouette gradients.
    assert np.abs(g_t["centers"]).max() > 0 and np.abs(g_t["radii"]).max() > 0
    if plane:
        assert np.abs(g_t["plane"][:3]).max() == 0.0 and g_t["plane"][3] != 0.0
    _assert_soft_grads_match(g_t, g_j, plane)


@pytest.mark.parametrize("plane", [False], ids=["soft"])
def test_soft_eager_gradients_match_jax(plane):
    check_soft_gradients(plane, regen=False)


def test_decoupled_loss_matches_jax():
    """Value: the full-spp MSE, as the JAX package's; gradient: the
    independent-pair estimator (first half's detached residual times the
    second half's pullback), against JAX's on the same pixels."""
    scene, cam, cfg, seed = _setup(False)
    perm = _kept_pixels(scene, cam, cfg, seed, False)
    l_j, g_j = _jax_grads(scene, cam, cfg, seed, False, perm, loss=jinv.pixel_loss_decoupled)
    l_t, g_t = _port_grads(scene, cam, cfg, seed, False, perm, loss=tpt.pixel_loss_decoupled)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    _assert_soft_grads_match(g_t, g_j, False)
    # The value is pixel_loss's; the gradient is not (it differentiates the
    # second half of the samples only).
    l_p, g_p = _port_grads(scene, cam, cfg, seed, False, perm)
    np.testing.assert_allclose(l_t, l_p, rtol=1e-6)
    assert np.abs(g_p["centers"] - g_t["centers"]).max() > 1e-6
