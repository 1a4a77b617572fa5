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

``fit`` also takes the JAX ``fit``'s cost-balanced pixel order
(``balance``, ``render.balanced_pixel_perm``), the gradient-accumulated
estimator (``grad_accum``, ``make_accum_grad_step``) and snapshots of the
fit's state (``snapshot_path``; the port's own file format).
``fit_sharded`` runs the fit over a ``parallel`` mesh of processes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .checkpoint import atomic_savez
from .ops.sampling import fold_in
from .render import balanced_pixel_perm, grad_safe_config, render_sample_batch
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


class AccumGradStep:
    """The gradient-accumulated estimator of ``make_accum_grad_step``:
    ``step(params, key) -> (loss, grads)``.

    ``image`` is the forward-only image; ``group_grad`` is one group's
    pullback of a pixel cotangent.  Each group's graph is freed before the
    next one is built, so one group's residuals are alive at a time.
    """

    def __init__(self, static_scene, target, camera, config, n_groups, device=None):
        if n_groups < 1 or config.spp % n_groups:
            raise ValueError(f"n_groups={n_groups} must divide spp={config.spp}")
        dev = resolve_device(device)
        _check_device(dev, static_scene.centers, target)
        self.static_scene, self.target, self.camera = static_scene, target, camera
        self.spp, self.n_groups = config.spp, n_groups
        self.sub_spp = config.spp // n_groups
        self.gcfg = grad_safe_config(config, dev)
        # The image must come from the groups' estimator: the forward-only
        # persistent kernel renders hard silhouettes only.
        self.fwd_cfg = (
            config if config.use_pallas and config.silhouette_softness == 0.0 else self.gcfg
        )

    def image(self, params, key):
        """Forward-only linear image [H, W, 3] of all spp."""
        with torch.no_grad():
            scene = merge_params({k: v.detach() for k, v in params.items()},
                                 self.static_scene)
            return render_linear(scene, self.camera, self.fwd_cfg, key)

    def group_grad(self, params, ct, key, k):
        """{leaf: d(ct . image_k)} of group ``k``: samples [k sub_spp,
        (k + 1) sub_spp), each weighted 1 / spp as in the full image."""
        leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
        scene = merge_params(leaves, self.static_scene)
        acc = render_sample_batch(
            scene, self.camera, self.gcfg.replace(spp=self.sub_spp), key,
            k * self.sub_spp, self.sub_spp,
        )
        out = acc.reshape(self.target.shape) / self.spp
        grads = torch.autograd.grad(out, list(leaves.values()), grad_outputs=ct,
                                    allow_unused=True)
        return {n: torch.zeros_like(v) if g is None else g
                for (n, v), g in zip(leaves.items(), grads)}

    def __call__(self, params, key):
        img = self.image(params, fold_in(key, 7777))
        loss = torch.mean((img - self.target) ** 2)
        ct = 2.0 * (img - self.target) / float(self.target.numel())
        grads = None
        for k in range(self.n_groups):
            g = self.group_grad(params, ct, key, k)
            grads = g if grads is None else {n: grads[n] + g[n] for n in grads}
        return loss, grads


def make_accum_grad_step(static_scene, target, camera, config, n_groups: int,
                         device=None) -> AccumGradStep:
    """Gradient-accumulated loss and gradient for spp beyond one call's
    budget: ``step(params, key) -> (loss, grads)``.

    One forward-only render of all spp (under ``torch.no_grad()``; with
    ``use_pallas`` and hard silhouettes the persistent kernel, else
    ``grad_safe_config``'s route) with the independent key ``fold_in(key,
    7777)`` gives the image and the pixel cotangent ct = 2 (img - target) /
    N.  The gradient is the sum over ``n_groups`` disjoint sample ranges of
    each range's pullback of ct, one ``torch.autograd.grad`` per group.
    Residual and differentiated samples are independent, so the estimator
    is unbiased for the gradient of the expected image's loss; its values
    are not ``pixel_loss``'s (another estimator, the same minimizer).
    ``device`` as in ``pixel_loss``."""
    return AccumGradStep(static_scene, target, camera, config, n_groups, device)


def make_optimizer(params, lr: float = 1e-2) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init(scene: Scene, lr: float = 1e-2, leaves=DIFF_LEAVES):
    """(params as leaf tensors that require grad, their Adam optimizer)."""
    params, _ = split_params(scene, leaves)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return params, make_optimizer(params, lr)


# Version of the port's fit snapshot format.
_FIT_SNAPSHOT_VERSION = 1


def _save_fit_state(path, params, opt, step, losses):
    """Atomically write a fit's state: each leaf's value and its Adam state
    (``step``, ``exp_avg``, ``exp_avg_sq``, each with its dtype), the step
    count and the losses so far."""
    payload = {
        "version": np.int64(_FIT_SNAPSHOT_VERSION),
        "step": np.int64(step),
        "losses": np.asarray(losses, np.float64),
        "leaves": np.asarray(list(params)),
    }
    for name, p in params.items():
        payload[f"param.{name}"] = p.detach().cpu().numpy()
        for field, value in opt.state.get(p, {}).items():
            payload[f"adam.{name}.{field}"] = value.detach().cpu().numpy()
    atomic_savez(path, payload)


def _load_fit_state(path, params, opt):
    """Restore a fit snapshot into ``params`` (in place) and ``opt``;
    returns (step, losses).  Raises ``ValueError`` on a snapshot this port
    did not write or whose leaves differ."""
    with np.load(path) as z:
        if "n_leaves" in z:
            raise ValueError(
                f"{path!r} is a fit snapshot of the JAX package (an optax pytree), "
                "which the port cannot restore: delete it to start the fit fresh"
            )
        version = int(z["version"])
        if version != _FIT_SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported fit snapshot version {version} in {path!r} (expected "
                f"{_FIT_SNAPSHOT_VERSION}): stale or corrupt; delete it to start the fit fresh"
            )
        names = [str(n) for n in z["leaves"]]
        if names != list(params):
            raise ValueError(f"{path!r} holds the leaves {names}, this fit fits {list(params)}")
        state = {}
        for i, name in enumerate(names):
            with torch.no_grad():
                params[name].copy_(torch.as_tensor(z[f"param.{name}"]))
            prefix = f"adam.{name}."
            fields = {k[len(prefix):]: torch.as_tensor(z[k]) for k in z.files
                      if k.startswith(prefix)}
            if fields:
                state[i] = fields
        step = int(z["step"])
        losses = [float(x) for x in z["losses"]]
    # load_state_dict casts exp_avg / exp_avg_sq to each leaf's dtype and
    # device and keeps ``step`` as saved, as Adam keeps it.
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})
    return step, losses


def _masked_step(opt, params, param_mask, scene_init):
    """One optimizer step on ``params``' gradients; ``param_mask`` ({leaf:
    0/1 tensor}) zeroes the frozen entries' gradients first and holds
    their values at ``scene_init``'s after."""
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
    ``scene_init``'s.

    ``grad_accum=K`` > 0: each step takes the gradient-accumulated estimator
    (``make_accum_grad_step``, K groups of spp / K samples); it renders in
    image order, so it excludes ``balance``.
    ``balance``: every step renders the pixels in the cost-balanced order of
    ``render.balanced_pixel_perm`` (the loss up to the order of its sum),
    probed with ``key`` on ``scene_init`` and again on the current scene
    every ``rebalance_every`` steps (0: never) with ``fold_in(key, 100_000
    + i)``.
    ``snapshot_path`` + ``snapshot_every``: every ``snapshot_every`` steps
    the leaves, the Adam state, the step and the losses are written
    atomically to ``snapshot_path``; a fit that finds the file resumes from
    it.  The file is the port's own format (version 1); the JAX package's
    fit snapshots raise ``ValueError``.  On the CPU a resumed fit is bit-
    identical to an uninterrupted one.  On CUDA the snapshot's round trip
    is bit-exact, but the gradient kernels' bucket sums rows with shared-
    memory atomics whose order changes from run to run, so a resumed fit
    follows an uninterrupted one as two uninterrupted fits follow each
    other: on the cover preset's albedo and sky, within rtol 1e-4 over four
    steps.  A leaf whose gradient is near zero (fuzz, ior) can take Adam
    steps of opposite sign in two runs and part them further.

    Returns (scene, losses).  ``device`` as in ``pixel_loss``.
    """
    dev = resolve_device(device)
    if softness and any(k in leaves for k in _GEOMETRY_LEAVES):
        config = config.replace(silhouette_softness=float(softness))
    config = fit_config(config, dev)
    loss_fn = pixel_loss_decoupled if config.silhouette_softness > 0.0 else pixel_loss
    params, opt = init(scene_init, lr, leaves)
    static_scene = scene_init
    balance = balance and not grad_accum
    pixel_perm = balanced_pixel_perm(scene_init, camera, config, key) if balance else None
    accum_step = (make_accum_grad_step(static_scene, target, camera, config, grad_accum, dev)
                  if grad_accum else None)
    losses, start = [], 0
    if snapshot_path and os.path.exists(snapshot_path):
        start, losses = _load_fit_state(snapshot_path, params, opt)
    for i in range(start, steps):
        if balance and rebalance_every and i > start and (i - start) % rebalance_every == 0:
            current = merge_params({k: v.detach() for k, v in params.items()}, static_scene)
            pixel_perm = balanced_pixel_perm(current, camera, config, fold_in(key, 100_000 + i))
        opt.zero_grad(set_to_none=True)
        if accum_step is not None:
            loss, grads = accum_step(params, fold_in(key, i))
            for k, g in grads.items():
                params[k].grad = g
        else:
            loss = loss_fn(params, static_scene, target, camera, config,
                           fold_in(key, i), leaves, pixel_perm=pixel_perm, device=dev)
            loss.backward()
        _masked_step(opt, params, param_mask, scene_init)
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1], params)
        if snapshot_path and snapshot_every and (i + 1) % snapshot_every == 0:
            _save_fit_state(snapshot_path, params, opt, i + 1, losses)
    final = {k: v.detach() for k, v in params.items()}
    return merge_params(final, static_scene), losses


def fit_sharded(
    scene_init: Scene,
    target,
    camera: Camera,
    config: RenderConfig,
    key,
    mesh,
    steps: int = 100,
    lr: float = 1e-2,
    leaves=DIFF_LEAVES,
    callback=None,
    param_mask=None,
    snapshot_path=None,
    snapshot_every: int = 0,
    device=None,
):
    """Adam fit over a ``parallel`` mesh: the distributed training loop.

    Each step runs ``parallel.loss_and_grad_sharded`` (the sharded render,
    its pullback on every rank, the gradients summed over the mesh) with
    the key ``fold_in(key, i)``, then the same Adam update on every rank
    (``torch.optim.Adam``, as ``fit``).  The loss and gradients are the
    same on every rank, so every rank holds the same leaves and optimizer
    state.  As in the JAX package there is no ``softness`` argument: the
    config's ``silhouette_softness`` rules.  ``param_mask`` works as in
    ``fit``.  Snapshots are ``fit``'s format, written by rank 0 alone (the
    state is replicated; two writers of one path could collide on the
    temporary file); every rank resumes from the same path.  Returns
    (scene, losses).  ``device`` as in ``pixel_loss``; the scene and
    target lie there on every rank.
    """
    import torch.distributed as dist

    from .parallel.sharding import loss_and_grad_sharded

    dev = resolve_device(device)
    _check_device(dev, scene_init.centers, target)
    config = grad_safe_config(config, dev)
    params, opt = init(scene_init, lr, leaves)
    losses, start = [], 0
    if snapshot_path and os.path.exists(snapshot_path):
        start, losses = _load_fit_state(snapshot_path, params, opt)
    for i in range(start, steps):
        opt.zero_grad(set_to_none=True)
        scene = merge_params({k: v.detach() for k, v in params.items()}, scene_init)
        loss, grads = loss_and_grad_sharded(scene, target, camera, config, fold_in(key, i),
                                            mesh)
        for k, p in params.items():
            p.grad = grads[k]
        _masked_step(opt, params, param_mask, scene_init)
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1], params)
        if (snapshot_path and snapshot_every and (i + 1) % snapshot_every == 0
                and dist.get_rank() == 0):
            _save_fit_state(snapshot_path, params, opt, i + 1, losses)
    final = {k: v.detach() for k, v in params.items()}
    return merge_params(final, scene_init), losses


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
