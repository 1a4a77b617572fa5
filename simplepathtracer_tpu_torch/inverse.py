"""Inverse rendering: recover scene leaves from a target image by pixel-loss
gradients (counterpart of the JAX package's ``inverse.py``, hard leaves).

``fit`` runs Adam (``torch.optim.Adam`` with optax.adam's defaults) on the
differentiable leaves of a scene.  ``pixel_loss`` renders through
``grad_safe_config``'s route for the device: the regeneration gradient
kernels on CUDA, plain autograd on the CPU.  Discrete structure (the hit
selection, the material switch, Schlick coins) is locally constant, as in
the JAX package.

Not ported yet, and raising ``NotImplementedError`` rather than being
ignored: soft silhouettes (``softness > 0`` with geometry leaves,
``pixel_loss_decoupled``; ROADMAP A.11), cost-balanced pixel order
(``balance``), the gradient-accumulated estimator (``grad_accum``,
``make_accum_grad_step``), fit snapshots (``snapshot_path``; A.14) and
camera fits (``fit_camera``; A.12).
"""

from __future__ import annotations

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


def pixel_loss_decoupled(*args, **kwargs):
    """The independent-pair estimator of soft-silhouette fits: not ported
    (ROADMAP A.11)."""
    raise NotImplementedError(
        "pixel_loss_decoupled (soft silhouettes) is not ported yet: ROADMAP A.11"
    )


def make_accum_grad_step(*args, **kwargs):
    """The gradient-accumulated estimator: not ported yet."""
    raise NotImplementedError(
        "make_accum_grad_step (grad_accum) is not ported yet: ROADMAP A.9 leftovers"
    )


def fit_camera(*args, **kwargs):
    """Camera pose fits: not ported (ROADMAP A.12)."""
    raise NotImplementedError("fit_camera is not ported yet: ROADMAP A.12")


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
    ``param_mask``: optional {leaf: 0/1 tensor} freezing entries -- their
    gradients are zeroed before the update and their values held at
    ``scene_init``'s.  Returns (scene, losses).  ``device`` as in
    ``pixel_loss``.  The options of the JAX ``fit`` that are not ported
    raise ``NotImplementedError``.
    """
    del rebalance_every, snapshot_every
    if softness and any(k in leaves for k in _GEOMETRY_LEAVES):
        raise NotImplementedError(
            f"fit(softness={softness}) with geometry leaves: soft silhouettes "
            "are not ported yet (ROADMAP A.11); pass softness=0.0"
        )
    if balance:
        raise NotImplementedError(
            "fit(balance=True): balanced_pixel_perm is not ported yet (ROADMAP A.8)"
        )
    if grad_accum:
        raise NotImplementedError(
            "fit(grad_accum=...): make_accum_grad_step is not ported yet (ROADMAP A.9)"
        )
    if snapshot_path:
        raise NotImplementedError(
            "fit(snapshot_path=...): fit snapshots are not ported yet (ROADMAP A.14)"
        )
    dev = resolve_device(device)
    config = grad_safe_config(config, dev)
    params, opt = init(scene_init, lr, leaves)
    static_scene = scene_init
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = pixel_loss(params, static_scene, target, camera, config,
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
