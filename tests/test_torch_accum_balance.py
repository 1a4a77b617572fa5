"""The gradient-accumulated estimator and cost-balanced fits of the port on
the CPU: the group sum is exactly the full-spp pullback (linearity; the
shapes of ``tests/test_inverse.py``'s test of it), ``make_accum_grad_step``
against the JAX one on the same tables and key (loss rtol 1e-5, the smooth
leaves' gradients rtol 1e-4), ``fit(grad_accum=2)`` recovering albedo,
``balanced_pixel_perm`` and ``fit(balance=True)`` (``tests/test_balance.py``'s
shapes, on the port's regen route: the plain versions of its kernels)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu import inverse as jinv
from simplepathtracer_tpu_torch import inverse, tracing
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy

# The module (the package's ``render`` is the function).
render = importlib.import_module("simplepathtracer_tpu_torch.render")


def _trio(width, height, spp, depth):
    scene = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    return scene, cam, tpt.RenderConfig(width=width, height=height, spp=spp, max_depth=depth)


def test_group_sum_is_the_full_pullback():
    scene, cam, cfg = _trio(16, 8, 4, 3)
    key = tpt.make_key(3)
    ct = torch.from_numpy(np.random.default_rng(9).standard_normal((8, 16, 3), np.float32))
    step = inverse.make_accum_grad_step(scene, ct, cam, cfg, 2, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in inverse.split_params(scene)[0].items()}
    img = render.render_sample_batch(inverse.merge_params(params, scene), cam, cfg, key, 0, 4)
    full = torch.autograd.grad(img.reshape(8, 16, 3) / 4.0, list(params.values()),
                               grad_outputs=ct, allow_unused=True)
    groups = [step.group_grad(params, ct, key, k) for k in range(2)]
    for (name, _), g in zip(params.items(), full):
        g = torch.zeros_like(params[name]) if g is None else g
        torch.testing.assert_close(groups[0][name] + groups[1][name], g, rtol=1e-5, atol=1e-7,
                                   msg=name)


def test_accum_grad_step_matches_jax():
    jscene = spt.three_sphere_scene(hollow_glass=False)
    jcam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
    jcfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=3)
    target = np.random.default_rng(4).uniform(0.0, 0.6, (8, 16, 3)).astype(np.float32)
    perturbed = jscene.replace(albedo=jnp.clip(jscene.albedo + 0.15, 0.05, 0.95))
    jparams, jstatic = jinv.split_params(perturbed)
    jloss, jgrads = jinv.make_accum_grad_step(jstatic, jnp.asarray(target), jcam, jcfg, 2)(
        jparams, jax.random.PRNGKey(5))

    scene = convert_scene(perturbed, device="cpu")
    cam = convert_camera(jcam, device="cpu")
    cfg = tpt.RenderConfig(width=16, height=8, spp=4, max_depth=3)
    params = inverse.split_params(scene)[0]
    step = inverse.make_accum_grad_step(scene, torch.from_numpy(target), cam, cfg, 2,
                                        device="cpu")
    loss, grads = step(params, tpt.make_key(5))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = params_to_numpy(grads)
    for leaf in ("albedo", "sky_lo", "sky_hi"):
        np.testing.assert_allclose(got[leaf], np.asarray(jgrads[leaf]), rtol=1e-4, atol=1e-7,
                                   err_msg=leaf)


def test_grad_accum_fit_recovers_albedo():
    scene, cam, cfg = _trio(24, 12, 8, 3)
    key = tpt.make_key(2)
    target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 9))
    perturbed = scene.replace(albedo=torch.clamp(scene.albedo + 0.25, 0.05, 0.95))
    recovered, losses = tpt.fit(perturbed, target, cam, cfg, key, steps=12, lr=5e-2,
                                leaves=("albedo",), grad_accum=2, device="cpu")
    assert losses[-1] < losses[0] * 0.7, losses[::4]
    err0 = (perturbed.albedo - scene.albedo).abs().mean().item()
    err1 = (recovered.albedo - scene.albedo).abs().mean().item()
    assert err1 < err0 * 0.7, (err0, err1)


def test_balanced_pixel_perm_and_probe_counts():
    """A permutation of the pixels, costliest first (one bank on the card):
    the probe's per-pixel bounce iterations, each within [spp, spp x depth]."""
    scene = tpt.reference_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device="cpu")
    cfg = tpt.RenderConfig(width=40, height=26, spp=4, max_depth=6)
    key = tpt.make_key(0)
    perm = tpt.balanced_pixel_perm(scene, cam, cfg, key, probe_spp=4)
    assert sorted(perm.tolist()) == list(range(cfg.num_pixels))
    pix = torch.arange(cfg.num_pixels)
    _, counts = render._render_block_pallas(scene, cam, cfg, key, pix, 0, 4, return_counts=True)
    assert (counts >= 4).all() and (counts <= 4 * cfg.max_depth).all()
    assert (counts[perm][1:] <= counts[perm][:-1]).all()


def test_fit_rebalance_matches_unbalanced(monkeypatch):
    """balance=True re-probes the current scene every rebalance_every steps;
    the order changes no sample, so the losses follow the unbalanced fit's
    up to the loss sum's order."""
    scene, cam, cfg = _trio(32, 16, 2, 4)
    cfg = cfg.replace(use_pallas_grad=True, grad_regen=True)
    key = tpt.make_key(2)
    target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 9))
    perturbed = scene.replace(albedo=torch.clamp(scene.albedo + 0.2, 0.05, 0.95))
    kw = dict(steps=5, lr=3e-2, leaves=("albedo",), device="cpu")
    probes = []
    real = render._render_block_pallas

    def counting(*a, **k):
        probes.append(k.get("return_counts", False))
        return real(*a, **k)

    before = tracing.counts()
    _, losses_u = tpt.fit(perturbed, target, cam, cfg, key, **kw)
    # The regen route's plain versions.
    assert (tracing.counts() - before)["plain.regen_bwd_reference"] > 0
    monkeypatch.setattr(render, "_render_block_pallas", counting)
    _, losses_b = tpt.fit(perturbed, target, cam, cfg, key, balance=True, rebalance_every=2, **kw)
    assert probes == [True] * 3  # steps 0, 2 and 4
    np.testing.assert_allclose(losses_b, losses_u, rtol=1e-4)
