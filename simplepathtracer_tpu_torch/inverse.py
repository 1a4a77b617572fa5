"""Inverse rendering: recover scene leaves from a target image by pixel-loss
gradients (counterpart of the JAX package's ``inverse.py``).

``fit`` runs Adam (``torch.optim.Adam`` with optax.adam's defaults) on the
differentiable leaves of a scene.  ``pixel_loss`` renders through
``grad_safe_config``'s route for the device: for a ``use_pallas`` preset
the regeneration gradient kernels on CUDA, plain autograd on the CPU; a
``use_pallas_hits`` config takes the closest-hit-attributes kernel under
the eager bounce.  On CUDA ``fit`` gives a config that names no kernel
route the fused gradient kernels (``fit_config``).  Discrete structure
(the hit selection, the material switch, Schlick coins) is locally
constant, as in the JAX package.  With ``softness`` > 0 and a geometry leaf fitted (the
default), ``fit`` turns on two-sided soft silhouettes and differentiates
``pixel_loss_decoupled``.  ``fit_camera`` fits camera leaves (origin,
lookat, vfov) the same way through ``camera_pixel_loss``: on CUDA the fused
gradient kernels, whose backward returns the rays' cotangents, under the
differentiable ray generation.

Not ported yet, and raising ``NotImplementedError`` rather than being
ignored: cost-balanced pixel order (``balance``), the gradient-accumulated
estimator (``grad_accum``, ``make_accum_grad_step``) and fit snapshots
(``snapshot_path``), each under its item of ROADMAP queue A
(``balanced_pixel_perm``, ``make_accum_grad_step``, ``checkpoint``).
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.sampling import fold_in
from .render import grad_safe_config, render_sample_batch
from .types import Camera, RenderConfig, Scene, resolve_device

# Leaves that receive gradients; ``plane`` is absent on sphere-only scenes,
# and only its offset + albedo (entries 3:7) receive gradients.
DIFF_LEAVES = (
    "centers", "radii", "albedo", "fuzz", "ior", "sky_lo", "sky_hi", "plane",
)
_GEOMETRY_LEAVES = ("centers", "radii", "plane")


def split_params(scene: Scene, leaves=DIFF_LEAVES):
    """({leaf: tensor} for the scene's leaves among ``leaves``, scene)."""
    params = {k: v for k in leaves if (v := getattr(scene, k)) is not None}
    return params, scene


def merge_params(params, scene: Scene) -> Scene:
    return scene.replace(**params)


def render_linear(scene, camera, config, key):
    """Sample-mean linear radiance image [H, W, 3] (pre-gamma): the quantity
    losses are defined on."""
    acc = render_sample_batch(scene, camera, config, key, 0, config.spp)
    return (acc / config.spp).reshape(config.height, config.width, 3)


def _check_device(dev, *tensors):
    for t in tensors:
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"expected tensors on {dev}, got {t.device}")


def pixel_loss(params, static_scene, target, camera, config, key,
               leaves=DIFF_LEAVES, pixel_perm=None, device=None):
    """Mean squared error in linear radiance, differentiable in ``params``.

    ``device`` (CUDA unless named) picks the gradient route
    (``grad_safe_config``); the scene and target must lie there.
    ``pixel_perm`` (optional [P] int): render pixels in this order and
    compare against the identically permuted target -- the same loss up to
    the order of the mean's sum.
    """
    dev = resolve_device(device)
    config = grad_safe_config(config, dev)
    scene = merge_params(params, static_scene)
    _check_device(dev, scene.centers, target)
    if pixel_perm is not None:
        acc = render_sample_batch(
            scene, camera, config, key, 0, config.spp, pixel_ids=pixel_perm
        )
        t = target.reshape(-1, 3)[pixel_perm]
        return torch.mean((acc / config.spp - t) ** 2)
    img = render_linear(scene, camera, config, key)
    return torch.mean((img - target) ** 2)


def pixel_loss_decoupled(params, static_scene, target, camera, config, key,
                         leaves=DIFF_LEAVES, pixel_perm=None, device=None):
    """MSE whose value is the full-spp render's and whose gradient is the
    independent-pair estimator: the residual of the first half of the
    sample range (detached, rendered forward only) times the pullback of
    the second half.

    The soft-silhouette score terms share their coins with the image the
    residual is built from, so the gradient of ``pixel_loss`` would also
    differentiate the sample variance; splitting the sample range
    decorrelates the two.  ``fit`` uses it whenever softness > 0.
    Arguments as in ``pixel_loss``."""
    dev = resolve_device(device)
    config = grad_safe_config(config, dev)
    scene = merge_params(params, static_scene)
    _check_device(dev, scene.centers, target)
    spp = int(config.spp)
    h = max(spp // 2, 1)
    kwargs = {} if pixel_perm is None else {"pixel_ids": pixel_perm}
    fixed = scene.replace(**{
        k: getattr(scene, k).detach() for k in DIFF_LEAVES if getattr(scene, k) is not None
    })
    acc_a = render_sample_batch(fixed, camera, config, key, 0, h, **kwargs)
    acc_b = render_sample_batch(scene, camera, config, key, h, spp - h, **kwargs)
    t = target.reshape(-1, 3)
    if pixel_perm is not None:
        t = t[pixel_perm]
    value = torch.mean(((acc_a + acc_b) / spp - t) ** 2)
    resid = (2.0 * (acc_a / h - t) / t.numel()).detach()
    gterm = torch.sum(resid * acc_b) / (spp - h)
    # The value is the full-spp MSE; the gradient is gterm's alone.
    return (value - gterm).detach() + gterm


def fit_config(config: RenderConfig, device=None) -> RenderConfig:
    """The config ``fit`` differentiates on ``device`` (CUDA unless named):
    ``grad_safe_config``'s, and on CUDA a config that names neither kernel
    route (``use_pallas_grad``, ``use_pallas_hits``) gets the fused
    gradient kernels, as the JAX ``fit`` does on the TPU."""
    dev = resolve_device(device)
    config = grad_safe_config(config, dev)
    if dev.type == "cuda" and not (config.use_pallas_grad or config.use_pallas_hits):
        config = config.replace(use_pallas_grad=True)
    return config


def make_accum_grad_step(*args, **kwargs):
    """The gradient-accumulated estimator: not ported yet."""
    raise NotImplementedError(
        "make_accum_grad_step (grad_accum) is not ported yet "
        "(ROADMAP queue A: make_accum_grad_step)"
    )


def make_optimizer(params, lr: float = 1e-2) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init(scene: Scene, lr: float = 1e-2, leaves=DIFF_LEAVES):
    """(params as leaf tensors that require grad, their Adam optimizer)."""
    params, _ = split_params(scene, leaves)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return params, make_optimizer(params, lr)


def fit(
    scene_init: Scene,
    target,
    camera: Camera,
    config: RenderConfig,
    key,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=DIFF_LEAVES,
    callback=None,
    softness: float = 0.02,
    param_mask=None,
    snapshot_path=None,
    snapshot_every: int = 0,
    balance: bool = False,
    rebalance_every: int = 25,
    grad_accum: int = 0,
    device=None,
):
    """Adam-optimize the scene's differentiable leaves against ``target``.

    Step i renders with the key ``fold_in(key, i)``, so gradient noise is
    fresh every step and a step's key does not depend on history.
    ``softness`` > 0 with a geometry leaf (centers, radii, plane) among
    ``leaves`` sets ``silhouette_softness`` and differentiates
    ``pixel_loss_decoupled``; render the target soft-to-soft for geometry
    fits.
    ``param_mask``: optional {leaf: 0/1 tensor} freezing entries -- their
    gradients are zeroed before the update and their values held at
    ``scene_init``'s.  Returns (scene, losses).  ``device`` as in
    ``pixel_loss``.  The options of the JAX ``fit`` that are not ported
    raise ``NotImplementedError``.
    """
    del rebalance_every, snapshot_every
    if balance:
        raise NotImplementedError(
            "fit(balance=True): balanced_pixel_perm is not ported yet "
            "(ROADMAP queue A: balanced_pixel_perm)"
        )
    if grad_accum:
        raise NotImplementedError(
            "fit(grad_accum=...): make_accum_grad_step is not ported yet "
            "(ROADMAP queue A: make_accum_grad_step)"
        )
    if snapshot_path:
        raise NotImplementedError(
            "fit(snapshot_path=...): fit snapshots are not ported yet "
            "(ROADMAP queue A: checkpoint)"
        )
    dev = resolve_device(device)
    if softness and any(k in leaves for k in _GEOMETRY_LEAVES):
        config = config.replace(silhouette_softness=float(softness))
    config = fit_config(config, dev)
    loss_fn = pixel_loss_decoupled if config.silhouette_softness > 0.0 else pixel_loss
    params, opt = init(scene_init, lr, leaves)
    static_scene = scene_init
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, static_scene, target, camera, config,
                       fold_in(key, i), leaves, device=dev)
        loss.backward()
        with torch.no_grad():
            if param_mask is not None:
                for k, m in param_mask.items():
                    if k in params and params[k].grad is not None:
                        params[k].grad.mul_(m)
            opt.step()
            if param_mask is not None:
                for k, m in param_mask.items():
                    if k in params:
                        params[k].copy_(torch.where(m > 0, params[k], getattr(scene_init, k)))
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1], params)
    final = {k: v.detach() for k, v in params.items()}
    return merge_params(final, static_scene), losses


# Camera leaves fitted by ``fit_camera``: pose and field of view.  vup stays
# fixed, aperture and focus_dist are available but off (as in the JAX
# package).
CAMERA_LEAVES = ("origin", "lookat", "vfov_deg")


def split_camera(camera: Camera, leaves=CAMERA_LEAVES):
    """({leaf: tensor} for ``leaves``, camera)."""
    return {k: getattr(camera, k) for k in leaves}, camera


def merge_camera(params, camera: Camera) -> Camera:
    return camera.replace(**params)


def camera_pixel_loss(cam_params, camera0, scene, target, config, key,
                      decoupled=False, device=None):
    """Mean squared error in linear radiance as a function of camera
    leaves.  The render takes ``grad_safe_config``'s route with
    ``camera_grad``: rays from the differentiable ``generate_rays`` into
    the fused gradient kernels (CUDA) or the plain autograd path (CPU); the
    regeneration kernels and the raygen kernel detach the camera and are
    skipped.  ``decoupled`` (soft silhouettes): the value of the full-spp
    render, the gradient of the independent-pair estimator, as in
    ``pixel_loss_decoupled``.  ``device`` as in ``pixel_loss``."""
    dev = resolve_device(device)
    config = grad_safe_config(config.replace(camera_grad=True), dev).replace(grad_regen=False)
    camera = merge_camera(cam_params, camera0)
    _check_device(dev, scene.centers, target)
    spp = int(config.spp)
    if not decoupled:
        img = render_linear(scene, camera, config, key)
        return torch.mean((img - target) ** 2)
    h = max(spp // 2, 1)
    fixed = camera.replace(**{
        f.name: getattr(camera, f.name).detach() for f in dataclasses.fields(camera)
    })
    acc_a = render_sample_batch(scene, fixed, config, key, 0, h)
    acc_b = render_sample_batch(scene, camera, config, key, h, spp - h)
    t = target.reshape(-1, 3)
    value = torch.mean(((acc_a + acc_b) / spp - t) ** 2)
    resid = (2.0 * (acc_a / h - t) / t.numel()).detach()
    gterm = torch.sum(resid * acc_b) / (spp - h)
    return (value - gterm).detach() + gterm


def fit_camera(
    scene: Scene,
    target,
    camera_init: Camera,
    config: RenderConfig,
    key,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=CAMERA_LEAVES,
    callback=None,
    softness: float = 0.02,
    device=None,
):
    """Adam-optimize camera leaves against ``target`` (pose recovery, the
    camera-side counterpart of ``fit``).  ``softness`` > 0 sets
    ``silhouette_softness`` and differentiates the decoupled loss: for
    sky-lit Lambertian scenes the silhouettes carry most of the pose
    signal; render the target soft-to-soft.  Step i renders with the key
    ``fold_in(key, i)``.  Returns (camera, losses).  ``device`` as in
    ``pixel_loss``."""
    dev = resolve_device(device)
    params, camera0 = split_camera(camera_init, leaves)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = make_optimizer(params, lr)
    if softness:
        config = config.replace(silhouette_softness=float(softness))
    decoupled = config.silhouette_softness > 0.0
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = camera_pixel_loss(params, camera0, scene, target, config, fold_in(key, i),
                                 decoupled=decoupled, device=dev)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1], params)
    final = {k: v.detach() for k, v in params.items()}
    return merge_camera(final, camera0), losses
