"""The explicit-ray forward: the bounce-step kernel's plain version
(``ops/bounce_step.py``) against the JAX package's ``bounce_step_pallas``,
and ``trace_rays`` / ``render_pixels`` under ``use_pallas`` against the JAX
package's ``trace_rays_pallas``, both in Pallas interpret mode.

Both packages trace the SAME rays (the JAX package's camera rays or a
random state made with numpy) with the same key and (pixel, sample) ids.
Bounds, and why:

* one bounce on a random state (ground plane, Russian roulette): a live ray
  agrees when both packages leave it alive or dead alike and put its next
  origin within 1e-4 (relative, plus 1e-4): the same winner.  A winner at a
  knife edge may flip between XLA's and PyTorch's rounding, so at least
  99.5% of the live rays must agree, and on those the directions,
  throughput and radiance keep the repo's knife-edge bound: mean |d| <
  1e-4 and under 0.5% of channels over 1e-4
  (``tests/test_pallas_bounce.py:44-46``);
* whole traces: the radiance of every path keeps that bound against the
  JAX package's ``trace_rays_pallas`` on three_sphere and
  three_sphere_plane with RR 2 (32x16 px, 2 spp, depth 10).  On the cover
  preset (2,048 random pixels x 8 samples, depth 10, key 3) a few paths
  flip: XLA's CPU backend contracts the scan's multiply-adds into FMAs
  (its t differs from the IEEE float32 one by more than 1e-6 relative on
  14% of hits, ``test_torch_hits.py``), and the r = 0.2 spheres'
  discriminant cancels
  ~13 bits at the camera's distance, so a hit point moves by up to 1e-3
  and a grazing path changes course.  Each flipped path moves its radiance
  by up to ~1, so the mean |d| over paths measures the flips' radiance,
  not the route: on these rays the port's route is 1.6e-4 from the JAX
  kernel route and the JAX package's own jnp route 1.4e-4 (2.3e-4 on
  another draw of pixels).  So the cover case holds the share
  bound alone, under 0.5% of channels over 1e-4, where the routes part:
  the port's route 0.40% of channels, the eager route (matmul-expanded
  |oc|^2, which ``trace_rays`` took before the bounce-step port) 0.72%,
  the JAX package's jnp route 0.75%.  At 1,024 rays or depth 4 that
  share cannot tell the routes apart (0.24% against 0.48% at depth 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.camera import generate_rays as jax_generate_rays
from simplepathtracer_tpu.ops.pallas_bounce import bounce_step_pallas
from simplepathtracer_tpu.ops.sampling import camera_jitter as jax_camera_jitter
from simplepathtracer_tpu.ops.sampling import ray_keys as jax_ray_keys
from simplepathtracer_tpu.render import trace_rays as jax_trace_rays

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.convert import convert_scene
from simplepathtracer_tpu_torch.ops import bounce_step as bs
from simplepathtracer_tpu_torch.ops.sampling import ray_keys
from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs
from simplepathtracer_tpu_torch.render import trace_rays_pallas

KNIFE_MEAN, KNIFE_SHARE = 1e-4, 5e-3
_TRIO_CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)


def _knife_edge(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return d.mean(), (d > 1e-4).mean()


def _jax_tables(scene):
    return (
        scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2], scene.radii,
        scene.radii * scene.radii, scene.albedo[:, 0], scene.albedo[:, 1],
        scene.albedo[:, 2], scene.material.astype(jnp.int32), scene.fuzz, scene.ior,
    )


def test_bounce_step_reference_matches_jax_kernel():
    """One bounce (bounce 3, RR from bounce 2, ground plane, hollow glass)
    on a random SoA state: 2,048 rays, a fifth of them dead."""
    jscene = spt.with_ground_plane(spt.three_sphere_scene(hollow_glass=True))
    rng = np.random.default_rng(4)
    n, bounce, rr, k0, k1 = 2048, 3, 2, 0, 5
    o = rng.uniform((-2.0, -0.4, -1.5), (2.0, 1.0, 1.5), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tp = rng.uniform(0.02, 1.0, (n, 3)).astype(np.float32)
    rad = rng.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    alive = (rng.uniform(size=n) < 0.8).astype(np.float32)
    pix = rng.integers(0, 1 << 20, n).astype(np.uint32)
    samp = rng.integers(0, 64, n).astype(np.uint32)
    state = np.concatenate([o.T, d.T, tp.T, rad.T, alive[None]]).astype(np.float32)

    tiles = [jnp.asarray(p.reshape(-1, 128)) for p in state]
    tiles += [jnp.asarray(pix.reshape(-1, 128)), jnp.asarray(samp.reshape(-1, 128))]
    sky6 = jnp.concatenate([jscene.sky_lo, jscene.sky_hi]).astype(jnp.float32)
    meta = jnp.asarray([k0, k1, bounce], jnp.uint32)
    out = bounce_step_pallas(tuple(tiles), _jax_tables(jscene), sky6, meta, rr_start_depth=rr,
                             interpret=True, plane7=jscene.plane)
    j_next = np.stack([np.asarray(x).reshape(-1) for x in out])

    tscene = convert_scene(jscene, "cpu")
    call = bs.bounce_call(scene_inputs(tscene)[:11], torch.cat([tscene.sky_lo, tscene.sky_hi]),
                          tscene.plane, k0, k1, rr_start_depth=rr)
    t_next = bs.bounce_step_reference(
        call, torch.tensor(state), torch.tensor(pix.astype(np.int32)),
        torch.tensor(samp.astype(np.int32)), bounce).numpy()

    live = alive > 0
    # A dead ray keeps its state (the JAX kernel's dead rays are not part of
    # the contract: they depend on their 1024-ray block).
    np.testing.assert_array_equal(t_next[12][~live], 0.0)
    np.testing.assert_array_equal(t_next[:12, ~live], state[:12, ~live])
    assert 0.3 < (t_next[12][live] > 0).mean() < 0.95  # hits, misses and RR kills
    same = (j_next[12] == t_next[12]) & np.all(
        np.abs(j_next[0:3] - t_next[0:3]) <= 1e-4 * (1.0 + np.abs(t_next[0:3])), axis=0)
    share = same[live].mean()
    assert share >= 0.995, share
    keep = live & same
    mean, out_share = _knife_edge(j_next[3:12, keep], t_next[3:12, keep])
    assert mean < KNIFE_MEAN and out_share < KNIFE_SHARE, (mean, out_share)


def _trace_case(name):
    """(JAX scene, JAX camera, width, height, pixel ids, sample ids, depth,
    rr, seed, mean bound or None) of each traced case."""
    if name == "cover":
        scene, cam, _ = spt.PRESETS["cover"].build(jax.random.PRNGKey(0))
        w, h, spp = 1200, 800, 8
        pixels = np.random.default_rng(3).choice(w * h, 2048, replace=False).astype(np.int32)
        pids = np.tile(pixels, spp)
        sids = np.repeat(np.arange(spp, dtype=np.int32), pixels.size)
        return scene, cam, w, h, pids, sids, 10, 0, 3, None
    scene = spt.three_sphere_scene(hollow_glass=True)
    rr = 0
    if name == "three_sphere_plane":
        scene, rr = spt.with_ground_plane(scene), 2
    w, h, spp = 32, 16, 2
    pids = np.tile(np.arange(w * h, dtype=np.int32), spp)
    sids = np.repeat(np.arange(spp, dtype=np.int32), w * h)
    return scene, spt.make_camera(**_TRIO_CAM), w, h, pids, sids, 10, rr, 11, KNIFE_MEAN


@pytest.mark.parametrize("name", ["three_sphere", "three_sphere_plane", "cover"])
def test_trace_rays_pallas_matches_jax(name):
    """trace_rays with use_pallas (the port: the bounce-step kernel's plain
    version) against the JAX package's trace_rays_pallas, same rays."""
    jscene, jcam, w, h, pids, sids, depth, rr, seed, mean_bound = _trace_case(name)
    jkeys = jax_ray_keys(jax.random.PRNGKey(seed), jnp.asarray(pids), jnp.asarray(sids))
    o, d = jax_generate_rays(jcam, w, h, jnp.asarray(pids), jax_camera_jitter(jkeys))
    kw = dict(width=w, height=h, max_depth=depth, rr_start_depth=rr, use_pallas=True)
    a = np.asarray(jax_trace_rays(o, d, jkeys, jscene,
                                  spt.RenderConfig(**kw, pallas_interpret=True)))
    keys = ray_keys(tpt.make_key(seed), torch.as_tensor(pids), torch.as_tensor(sids))
    before = tracing.counts()
    with torch.no_grad():
        b = tpt.trace_rays(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), keys,
                           convert_scene(jscene, "cpu"), tpt.RenderConfig(**kw)).numpy()
    assert (tracing.counts() - before)["plain.bounce_step_reference"] == depth
    assert b.shape == (pids.shape[0], 3) and np.isfinite(b).all() and b.max() > 0
    mean, share = _knife_edge(a, b)
    assert share < KNIFE_SHARE, (mean, share)
    if mean_bound is not None:
        assert mean < mean_bound, (mean, share)


def _tiny():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(**_TRIO_CAM, device="cpu")
    cfg = tpt.RenderConfig(width=8, height=4, spp=2, max_depth=3, use_pallas=True)
    pids = torch.arange(32).repeat(2)
    sids = torch.arange(2).repeat_interleave(32)
    return scene, cam, cfg, pids, sids


def test_use_pallas_takes_precedence_in_trace_rays():
    """use_pallas sends trace_rays and render_pixels to trace_rays_pallas
    even with use_pallas_grad set, as in the JAX package; the fused kernels
    do not run."""
    scene, cam, cfg, pids, sids = _tiny()
    cfg = cfg.replace(use_pallas_grad=True)
    before = tracing.counts()
    rad = tpt.render_pixels(scene, cam, cfg, tpt.make_key(1), pids, sids)
    assert rad.shape == (64, 3) and torch.isfinite(rad).all()
    ran = tracing.counts() - before
    assert (ran["plain.bounce_step_reference"], ran["plain.grad_fwd_reference"]) == (
        cfg.max_depth, 0)


@pytest.mark.parametrize("needs", ["scene", "rays"])
def test_trace_rays_pallas_raises_under_a_required_gradient(needs):
    """The bounce-step route is forward only: asked for a gradient it
    raises instead of returning a detached result; under no_grad it runs."""
    scene, cam, cfg, pids, sids = _tiny()
    keys = ray_keys(tpt.make_key(1), pids, sids)
    o = torch.tensor([[0.0, 0.0, -1.0]]).repeat(64, 1)
    gen = torch.Generator().manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen), dim=1)
    if needs == "scene":
        scene = scene.replace(albedo=scene.albedo.clone().requires_grad_(True))
    else:
        d = d.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        trace_rays_pallas(o, d, keys, scene, cfg)
    with torch.no_grad():
        assert torch.isfinite(trace_rays_pallas(o, d, keys, scene, cfg)).all()


def test_bounce_step_wrapper_raises_off_cpu_and_cuda():
    scene, cam, cfg, pids, sids = _tiny()
    keys = ray_keys(tpt.make_key(1), pids, sids)
    call = bs.bounce_call([t.to("meta") for t in scene_inputs(scene)[:11]],
                          torch.zeros(6, device="meta"), None, keys.k0, keys.k1)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.bounce_step(call, torch.zeros((13, 4), device="meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"), 0)
