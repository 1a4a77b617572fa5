"""Camera gradients of the port (``inverse.camera_pixel_loss``,
``fit_camera``) against the JAX package and against finite differences.

The setups are ``tests/test_camera_grad.py``'s: ``three_sphere``
(hollow_glass=False), 48x24, depth 3, the camera at (0, 0, -1) looking down
+z with a 60 degree field of view.  The port runs both its routes on the
CPU: the eager route (plain autograd through ``trace_rays``) and the fused
route (``use_pallas_grad``: the fused kernels' plain versions, the route
CUDA takes), each with the differentiable ``generate_rays``.

Bounds, and why:

* camera-leaf gradients against ``jax.grad`` of the JAX package's
  ``camera_pixel_loss``: rtol 2e-4, atol 1e-7, the bound
  ``test_camera_grad.py:test_camera_gradient_paths_agree`` holds the JAX
  package's own two routes to.  The two packages' camera rays differ by an
  ulp (XLA's and PyTorch's rounding), which moves a few paths (glass, soft
  phantom winners) by more than 1e-6: pixels whose linear radiance
  differs by more than 1e-6 between the packages (on either port route)
  are knife-edge pixels, at most 2% of them, and each package's target
  there is its own image, so they add nothing to either gradient;
* the camera's side of the chain, the vector-Jacobian product of
  ``generate_rays`` on the main path's thin-lens cover camera (and
  three_sphere's pinhole) with random cotangents of ~6,000 rays: rtol 2e-4
  and atol 1e-4 against the JAX package's, each of the 7 components with
  its sign (the sums run over ~1e4 terms of order 1; measured |d| <=
  2e-5).  With the fused trace's per-ray cotangents held to the JAX
  package's on the cover scene, hard and soft
  (``test_torch_fused_kernels.py``), a sign that the port flips on the
  main path's camera gradient is caught.  The cover scene's end-to-end
  camera gradients are not compared: the few rays that XLA's rounding
  sends down another path (<= 1%) carry gradient terms far above the
  mean there, so no knife-edge mask brings the two packages' sums to a
  tight bound;
* AD/FD of ``vfov_deg`` (Lambertian, 256 spp, soft 0.05, eps 0.05): within
  rtol 0.25 (``test_camera_grad.py:test_camera_gradient_fd_smooth``; the
  JAX package measures 0.97);
* pose recovery: the origin's error at least halved in 40 steps
  (``test_camera_grad.py:test_camera_pose_fit_recovers_origin``, here at 4
  spp instead of 16);
* three ``fit_camera`` steps (default softness and decoupled loss) against
  the JAX package's on the fused route: losses within rtol 1e-3 (a soft
  path's knife edges flip between the packages), camera leaves within
  1e-4, a hundredth of one Adam step at lr 1e-2.
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
from simplepathtracer_tpu_torch.convert import convert_camera, convert_params, convert_scene

W, H, DEPTH = 48, 24, 3
KNIFE_EDGE_TOL, KNIFE_EDGE_SHARE = 1e-6, 0.02
ROUTES = {"eager": {}, "fused": dict(use_pallas_grad=True)}


def _jax_setup():
    return (spt.three_sphere_scene(hollow_glass=False),
            spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60))


def _port(scene, cam):
    return convert_scene(scene, "cpu"), convert_camera(cam, "cpu")


def _cfg(spp, softness, **flags):
    return tpt.RenderConfig(width=W, height=H, spp=spp, max_depth=DEPTH,
                            silhouette_softness=softness, **flags)


@pytest.fixture(scope="module", params=[0.0, 0.05], ids=["hard", "soft"])
def camera_case(request):
    """Per softness: the knife-edge pixels (either route's image off the
    JAX package's by more than KNIFE_EDGE_TOL), each package's masked
    target, and the JAX package's camera-leaf gradient (4 spp, key 3)."""
    soft = request.param
    scene, cam = _jax_setup()
    ts, tc = _port(scene, cam)
    jcfg = spt.RenderConfig(width=W, height=H, spp=4, max_depth=DEPTH, silhouette_softness=soft)
    img_j = np.asarray(jinv.render_linear(scene, cam, jcfg.replace(camera_grad=True),
                                          jax.random.PRNGKey(3)))
    imgs = {}
    with torch.no_grad():
        for route, flags in ROUTES.items():
            cfg = _cfg(4, soft, camera_grad=True, **flags)
            imgs[route] = tpt.render_linear(ts, tc, cfg, tpt.make_key(3)).numpy()
    edge = np.zeros((H, W), bool)
    for img in imgs.values():
        edge |= np.abs(img - img_j).max(-1) > KNIFE_EDGE_TOL
    target_j = np.where(edge[..., None], img_j, 0.3).astype(np.float32)
    params, cam0 = jinv.split_camera(cam)
    g_j = jax.grad(jinv.camera_pixel_loss)(params, cam0, scene, jnp.asarray(target_j), jcfg,
                                           jax.random.PRNGKey(3))
    return dict(soft=soft, ts=ts, tc=tc, edge=edge, imgs=imgs,
                g_j={k: np.asarray(v) for k, v in g_j.items()})


@pytest.mark.parametrize("route", list(ROUTES))
def test_camera_grads_match_jax(camera_case, route):
    c = camera_case
    assert c["edge"].mean() <= KNIFE_EDGE_SHARE, c["edge"].mean()
    target = np.where(c["edge"][..., None], c["imgs"][route], 0.3).astype(np.float32)
    p, c0 = tpt.split_camera(c["tc"])
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = tpt.camera_pixel_loss(p, c0, c["ts"], torch.tensor(target),
                                 _cfg(4, c["soft"], **ROUTES[route]), tpt.make_key(3),
                                 device="cpu")
    g_t = torch.autograd.grad(loss, list(p.values()))
    assert set(p) == set(tpt.CAMERA_LEAVES)
    for k, g in zip(p, g_t):
        np.testing.assert_allclose(g.numpy(), c["g_j"][k], rtol=2e-4, atol=1e-7, err_msg=k)
    assert np.abs(g_t[0].numpy()).max() > 0


@pytest.mark.parametrize("name", ["three_sphere", "cover"])
def test_generate_rays_vjp_matches_jax(name):
    """The camera's side of the chain: the vector-Jacobian product of
    ``generate_rays`` (pinhole three_sphere; the cover preset's thin lens,
    aperture 0.1 and focus 10, the main path's camera) with random ray
    cotangents, against ``jax.vjp`` of the JAX package's."""
    from simplepathtracer_tpu.camera import generate_rays as jax_generate_rays
    from simplepathtracer_tpu_torch.camera import generate_rays

    if name == "cover":
        cam = spt.PRESETS["cover"].camera_fn()
        w, h = 48, 32
    else:
        cam = _jax_setup()[1]
        w, h = W, H
    rng = np.random.default_rng(5)
    n = 4 * w * h
    pix = np.tile(np.arange(w * h, dtype=np.int32), 4)
    jit = rng.random((n, 4), dtype=np.float32)
    ct_o, ct_d = rng.standard_normal((2, n, 3)).astype(np.float32)
    params, cam0 = jinv.split_camera(cam)

    def rays(p):
        return jax_generate_rays(jinv.merge_camera(p, cam0), w, h, jnp.asarray(pix),
                                 jnp.asarray(jit))

    _, vjp = jax.vjp(rays, params)
    (g_j,) = vjp((jnp.asarray(ct_o), jnp.asarray(ct_d)))
    p, c0 = tpt.split_camera(convert_camera(cam, "cpu"))
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    o, d = generate_rays(tpt.merge_camera(p, c0), w, h, torch.as_tensor(pix), torch.as_tensor(jit))
    g_t = torch.autograd.grad([o, d], list(p.values()), [torch.as_tensor(ct_o),
                                                           torch.as_tensor(ct_d)])
    for k, g in zip(p, g_t):
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=1e-4, err_msg=k)
        assert (np.sign(g.numpy()) == np.sign(want)).all(), (k, g, want)


def test_camera_vfov_ad_matches_fd():
    scene = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    scene = scene.replace(material=torch.zeros_like(scene.material))
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cfg = _cfg(256, 0.05, use_pallas_grad=True)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam.replace(vfov_deg=torch.tensor(62.0)), cfg,
                                   tpt.make_key(99))
    params, cam0 = tpt.split_camera(cam)

    def loss(p):
        return tpt.camera_pixel_loss(p, cam0, scene, target, cfg, tpt.make_key(3), device="cpu")

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    (g,) = torch.autograd.grad(loss(p), [p["vfov_deg"]])
    eps = 0.05
    with torch.no_grad():
        fd = (loss(dict(params, vfov_deg=params["vfov_deg"] + eps)).item()
              - loss(dict(params, vfov_deg=params["vfov_deg"] - eps)).item()) / (2 * eps)
    ad = g.item()
    assert np.isfinite(ad) and ad != 0.0
    np.testing.assert_allclose(ad, fd, rtol=0.25)


def test_camera_pose_fit_recovers_origin():
    scene = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cfg = _cfg(4, 0.05, use_pallas_grad=True)
    with torch.no_grad():
        target = tpt.render_linear(scene, cam, cfg, tpt.make_key(99))
    bad = cam.replace(origin=cam.origin + torch.tensor([0.06, -0.05, 0.0]))
    fitted, losses = tpt.fit_camera(scene, target, bad, cfg, tpt.make_key(3), steps=40, lr=8e-3,
                                    leaves=("origin",), softness=0.05, device="cpu")
    err0 = (bad.origin - cam.origin).norm().item()
    err1 = (fitted.origin - cam.origin).norm().item()
    assert err1 < 0.5 * err0, (err0, err1, losses[::10])
    assert torch.equal(fitted.lookat, cam.lookat) and torch.equal(fitted.vfov_deg, cam.vfov_deg)


def test_fit_camera_tracks_jax():
    scene, cam = _jax_setup()
    cfg = spt.RenderConfig(width=W, height=H, spp=4, max_depth=DEPTH)
    target = jinv.render_linear(scene, cam, cfg.replace(silhouette_softness=0.02),
                                jax.random.PRNGKey(99))
    bad = cam.replace(origin=cam.origin + jnp.asarray([0.06, -0.05, 0.0], jnp.float32),
                      vfov_deg=jnp.asarray(61.0, jnp.float32))
    fit_j, losses_j = jinv.fit_camera(scene, target, bad, cfg, jax.random.PRNGKey(3), steps=3,
                                      lr=1e-2)
    ts = convert_scene(scene, "cpu")
    fit_t, losses_t = tpt.fit_camera(ts, torch.tensor(np.asarray(target)),
                                     convert_camera(bad, "cpu"), _cfg(4, 0.0, use_pallas_grad=True),
                                     tpt.make_key(3), steps=3, lr=1e-2, device="cpu")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    want = convert_params(jinv.split_camera(fit_j)[0], "cpu")
    for k, v in tpt.split_camera(fit_t)[0].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    moved = (fit_t.origin - convert_camera(bad, "cpu").origin).abs().max().item()
    assert moved > 1e-2
