"""``fit`` with its own defaults (softness 0.02, every leaf: soft
silhouettes and the decoupled loss) against the JAX package's, and the
soft estimator's geometry gradient against finite differences.

* Three default-argument Adam steps on the eager route (the CPU's), 16x8
  px, 4 spp, depth 3, from a start with dimmed albedo and sky and three
  moved centers, against a soft-to-soft target.  The key is one whose three
  step keys render every path alike in the two packages (no knife-edge
  flip; see ``test_torch_soft_route.py``).  Bounds: losses rtol 1e-5;
  fitted leaves atol 5e-5 -- Adam's update is lr x m / sqrt(v), so a
  gradient off by the soft bound's 2e-3 moves a leaf by ~lr x 2e-3 = 4e-5
  per step at most.
* The half-buried sphere's radius (``tests/test_crossing.py:132-169``:
  48x24, 512 spp, depth 3, soft 0.05) on the port's eager route: AD / FD
  in (0.3, 1.8), the JAX package's bound for its own estimator.  That
  check is ``test_torch_soft_fit_fd.py``, a file of its own so the suite's
  workers run it beside the fits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse as jinv

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy

STEPS, LR, SEED = 3, 2e-2, 7


@pytest.fixture(scope="module")
def fits():
    scene = spt.three_sphere_scene(hollow_glass=False)
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=3)
    key = jax.random.PRNGKey(SEED)
    target = np.asarray(jinv.render_linear(scene, cam, cfg.replace(silhouette_softness=0.02),
                                           jax.random.fold_in(key, 9)))
    start = scene.replace(
        albedo=jnp.clip(scene.albedo * 0.6, 0.05, 0.95), sky_lo=scene.sky_lo * 0.8,
        sky_hi=scene.sky_hi * 0.8, centers=scene.centers.at[1:].add(0.05),
    )
    j_scene, j_losses = jinv.fit(start, jnp.asarray(target), cam, cfg, key, steps=STEPS, lr=LR)
    t_scene, t_losses = tpt.fit(
        convert_scene(start, "cpu"), torch.tensor(target), convert_camera(cam, "cpu"),
        tpt.RenderConfig(width=16, height=8, spp=4, max_depth=3), tpt.make_key(SEED),
        steps=STEPS, lr=LR, device="cpu",
    )
    leaves = [k for k in jinv.DIFF_LEAVES if getattr(start, k) is not None]
    j_params = {k: np.asarray(getattr(j_scene, k)) for k in leaves}
    t_params = params_to_numpy({k: getattr(t_scene, k) for k in leaves})
    start_params = {k: np.asarray(getattr(start, k)) for k in leaves}
    return j_losses, t_losses, j_params, t_params, start_params


def test_default_fit_matches_jax(fits):
    j_losses, t_losses, j_params, t_params, _ = fits
    assert len(t_losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_losses, [float(x) for x in j_losses], rtol=1e-5)
    for k in j_params:
        np.testing.assert_allclose(t_params[k], j_params[k], atol=5e-5, rtol=0, err_msg=k)


def test_default_fit_moves_geometry(fits):
    _, t_losses, _, t_params, start = fits
    assert t_losses[-1] < t_losses[0]
    # Soft silhouettes on by default: the centers and radii move.
    for k in ("centers", "radii"):
        assert np.abs(t_params[k] - start[k]).max() > 1e-3, k
