"""Which route a call takes: the port's one owner of that decision.

A route is one path from an entry point down to the kernels; ``CAPS`` says
what each carries.  ``pick`` chooses a call's route from the config's
kernel flags, in the JAX package's order, then falls back or raises where
the scene or config needs what the route lacks (an emissive scene never
falls back: a route without emission raises); a route's own entry point
raises (``check``).  The route does not depend on the device (a wrapper
takes its plain version on a CPU tensor): the device enters where a config
is made ready to differentiate (``grad_safe_config``, ``fit_config``).
"""

from __future__ import annotations

from typing import NamedTuple

from .ops.grad_regen import IDX_PACK, IDX_PACK_MAX_SPHERES
from .types import RenderConfig, resolve_device

PERSISTENT = "persistent"
BOUNCE_STEP = "bounce_step"
REGEN_STREAM = "regen_stream"
REGEN = "regen"
FUSED_RAYGEN = "fused_raygen"
FUSED = "fused"
HITS = "hits"
PLAIN = "plain"

# Entry points: a pixel block (``render_pixel_block`` and every render and
# loss built on it), ``render_pixels`` and ``trace_rays``.
BLOCK = "block"
PIXELS = "pixels"
RAYS = "rays"

# Rays differentiated per spp chunk on the plain (autograd) and hits routes:
# the JAX package's value, which bounds the residuals autograd keeps.
_GRAD_RAY_BUDGET = 2_000_000
# Ray-bounces (rays x max_depth) per spp chunk on the fused routes.  Their
# backward keeps 44 B per ray and bounce (entry state, winner index; soft:
# 48 B, the blocker index too; the JAX kernels keep 84 B / 104 B), so 500M
# hold 22-24 GB, under a third of an H100's 80 GB, beside autograd's
# generate_rays under camera gradients (~100 B a ray) and the backward's
# cotangents (~90 B a ray).  At the cover frame (1200x800, depth 10): 52-spp
# chunks, so the decoupled camera fit's 50 spp take one chunk, no remat.
_GRAD_RAY_BOUNCE_BUDGET_FUSED = 500_000_000
# Lane-iterations (spp x pixels x max_depth) per spp chunk on the regen
# routes.  A chunk's backward holds 25 residual and 9 cotangent planes, 136 B
# a lane-iteration (soft: 30 and 13, 172 B; an emissive scene adds the
# emission's 3 cotangent planes: 148 B, soft 184 B): 27.2-36.8 GB, a third
# to under half of an H100's 80 GB, beside the packed winner indices and the
# caller's tensors.  At the cover frame: 20-spp chunks (n_iter 207: 27.0 GB
# hard, 34.2 GB soft); the soft fit's 50 decoupled spp take 10-spp chunks
# (17.8 GB).  At smallpt's 1024x768 frame, depth 30: 8-spp chunks (n_iter
# 243, 191.1 M lane-iterations: 35.2 GB soft and emissive).  A larger chunk
# saves only launches: work and traffic grow with it.
_GRAD_ITER_BUDGET_REGEN = 200_000_000
# Bytes of packed winner indices (4 B per 3 lane-iterations; soft: the
# blocker indices too, 8 B) the streamed route may keep across all spp:
# 24 GiB on an H100's 80 GB, beside one chunk's 27-34 GB of planes.  At the
# cover frame that holds 3 x 24 GiB / (4 B x 960,000 x 10) = 2013 spp
# (soft: 1006); beyond, the backward re-records each chunk's indices.
_IDX_PLANE_BUDGET = 24 << 30


class Caps(NamedTuple):
    """What a route carries.  ``soft`` ``"hard"``: a soft config renders
    with hard silhouettes, as in the JAX package's forward kernels.
    ``slots``: the most spheres (None: only the kernels' shared memory
    bounds them).  ``budget``: the rays (``per_bounce``: ray-bounces) a spp
    chunk of its gradient may hold; 0: forward only.  ``fallback``: where a
    call goes that needs what this route lacks (None: it raises)."""

    plane: bool
    soft: bool | str
    emission: bool
    budget: int = 0
    per_bounce: bool = False
    slots: int | None = None
    fallback: str | None = None


_REGEN = dict(budget=_GRAD_ITER_BUDGET_REGEN, per_bounce=True)
_FUSED = dict(budget=_GRAD_RAY_BOUNCE_BUDGET_FUSED, per_bounce=True)
CAPS = {
    # The persistent kernel: a pixel block's samples in one launch.
    PERSISTENT: Caps(plane=True, soft="hard", emission=True),
    # Explicit rays, a bounce-step launch a bounce.
    BOUNCE_STEP: Caps(plane=True, soft="hard", emission=False),
    # The regeneration kernels over spp chunks: an index-only forward over
    # every sample, then per chunk a scan-free re-forward and the backward.
    REGEN_STREAM: Caps(plane=True, soft=True, emission=True, **_REGEN,
                       slots=IDX_PACK_MAX_SPHERES, fallback=REGEN),
    # The same kernels, one recording forward a chunk.
    REGEN: Caps(plane=True, soft=True, emission=True, **_REGEN),
    # The per-bounce fused kernels on raygen's camera rays.
    FUSED_RAYGEN: Caps(plane=False, soft=True, emission=False, **_FUSED, fallback=FUSED),
    # The fused kernels on explicit rays.
    FUSED: Caps(plane=False, soft=True, emission=False, **_FUSED, fallback=PLAIN),
    # The eager bounce, its closest hit from the closest-hit-attributes kernel.
    HITS: Caps(plane=False, soft=False, emission=False, budget=_GRAD_RAY_BUDGET,
               fallback=PLAIN),
    # The eager wavefront (render.trace_rays), autograd.
    PLAIN: Caps(plane=True, soft=True, emission=True, budget=_GRAD_RAY_BUDGET),
}

class Route(NamedTuple):
    """A call's route and what follows: whether it makes camera rays
    without the camera's gradient, the spp a chunk its budget allows at the
    call's frame (0: forward only, the samples loop in the kernel), and
    whether the streamed route keeps every chunk's winner words."""

    name: str
    forward_only: bool
    camera_detached: bool
    max_chunk: int
    keep_words: bool


def spp_chunk(config: RenderConfig, n_samples: int) -> int:
    """Samples per step of a block of ``n_samples``: ``spp_chunk`` (0: all),
    lowered to the largest divisor of ``n_samples``."""
    chunk = min(config.spp_chunk or n_samples, n_samples)
    while n_samples % chunk:
        chunk -= 1
    return chunk


def _asked(config: RenderConfig, entry: str, samples: int) -> str:
    """The route the config's flags name for ``entry``, in the JAX
    package's order."""
    if config.use_pallas:
        return PERSISTENT if entry == BLOCK else BOUNCE_STEP
    if config.use_pallas_grad:
        # The regeneration kernels consume pixel ids and detach the camera,
        # so camera_grad skips them (and raygen).
        if entry == BLOCK and config.grad_regen and not config.camera_grad:
            streamed = config.grad_regen_stream and samples // spp_chunk(config, samples) > 1
            return REGEN_STREAM if streamed else REGEN
        return FUSED if entry == RAYS or config.camera_grad else FUSED_RAYGEN
    return HITS if config.use_pallas_hits else PLAIN


def _lacks(name: str, scene, config: RenderConfig):
    """(exception class, what) of the first thing the call needs that route
    ``name`` does not carry, or None."""
    caps = CAPS[name]
    # (emitters() reads the table's count back from the device once a
    # version of it: asked only where the answer can refuse the call.)
    if scene.emission is not None and (not caps.emission or (config.camera_grad and caps.budget)) \
            and (scene.emission.requires_grad or scene.emitters()):
        if not caps.emission:
            return NotImplementedError, ("Scene.emission: only the persistent, regeneration and "
                                         "plain routes add emitted light (and only the last two "
                                         "differentiate it); dropping it would render another "
                                         "image")
        # camera_grad: the route must not depend on the device, and on CUDA
        # camera gradients take the fused kernels, which add no emission.
        return NotImplementedError, ("Scene.emission under camera_grad: the camera-gradient "
                                     "kernels (fused) add no emitted light")
    if not caps.plane and scene.plane is not None:
        return ValueError, "a ground plane: it is sphere-only"
    if not caps.soft and config.silhouette_softness > 0.0:
        return ValueError, "soft silhouettes: it is hard-only"
    if caps.slots is not None and scene.num_spheres > caps.slots:
        return ValueError, f"more than {caps.slots} spheres (its 10-bit winner code)"
    return None


def _refusal(name: str, lack) -> Exception:
    kind, what = lack
    return kind(f"the {name} route does not carry {what}")


def check(name: str, scene, config: RenderConfig, differentiates: bool = False) -> None:
    """Raise unless route ``name`` carries the scene and the config, with no
    fallback: what a route's own entry point asks when called directly.
    ``differentiates``: autograd needs a gradient through the call."""
    lack = _lacks(name, scene, config)
    if lack is not None:
        raise _refusal(name, lack)
    if differentiates and not CAPS[name].budget:
        raise RuntimeError(f"the {name} route (use_pallas) is forward only: clear use_pallas "
                           "(grad_safe_config) to differentiate, or run under torch.no_grad()")


def _words_capacity(config: RenderConfig, pixels: int) -> int:
    """The most spp whose packed winner words (``pixels`` wide; soft: the
    blockers' too) fit ``_IDX_PLANE_BUDGET``."""
    planes = 2 if config.silhouette_softness > 0.0 else 1
    return int(IDX_PACK * _IDX_PLANE_BUDGET // (planes * 4 * pixels * max(1, config.max_depth)))


def pick(scene, config: RenderConfig, *, entry: str = BLOCK, pixels: int | None = None,
         samples: int | None = None, differentiates: bool = False) -> Route:
    """The route of a call on ``scene`` (None: the config's decision alone)
    under ``config``.  ``entry``: ``BLOCK``, ``PIXELS`` or ``RAYS``;
    ``pixels`` and ``samples``: the block's counts (the config's frame and
    spp unless given); ``differentiates``: autograd records the call.
    ``use_pallas`` takes the forward kernels; ``use_pallas_grad`` for a
    block with ``grad_regen`` the regeneration kernels (streamed over more
    than one chunk under ``grad_regen_stream``), else the fused kernels
    (raygen unless the entry takes rays or under ``camera_grad``);
    ``use_pallas_hits`` the closest-hit kernels; nothing, the plain route."""
    pixels = config.num_pixels if pixels is None else pixels
    samples = config.spp if samples is None else samples
    name = _asked(config, entry, samples)
    if scene is not None:
        while (lack := _lacks(name, scene, config)) is not None:
            if CAPS[name].fallback is None or lack[0] is NotImplementedError:
                raise _refusal(name, lack)
            name = CAPS[name].fallback
    caps = CAPS[name]
    units = pixels * (max(1, config.max_depth) if caps.per_bounce else 1)
    return Route(
        name=name, forward_only=not caps.budget,
        camera_detached=name in (REGEN_STREAM, REGEN, FUSED_RAYGEN),
        max_chunk=max(1, caps.budget // units) if caps.budget else 0,
        keep_words=(name == REGEN_STREAM and differentiates
                    and samples <= _words_capacity(config, pixels)),
    )


def stream_capacity_spp(config: RenderConfig, scene) -> int:
    """Largest spp whose packed winner indices fit ``_IDX_PLANE_BUDGET``
    for this (config, scene): beyond it the streamed route re-records them.
    0 when the scene has more spheres than the streamed route carries."""
    if scene.num_spheres > CAPS[REGEN_STREAM].slots:
        return 0
    return _words_capacity(config, config.num_pixels)


def grad_safe_config(config: RenderConfig, device=None) -> RenderConfig:
    """A config for differentiating on ``device`` (CUDA unless named).

    ``use_pallas`` (the forward-only routes) is cleared: on CUDA the config
    takes the regeneration gradient kernels (``use_pallas_grad`` +
    ``grad_regen``), on the CPU the plain route, as the JAX package does
    off the TPU.  Without an ``spp_chunk``, one is picked that keeps a
    chunk's differentiated work within the route's budget."""
    if pick(None, config).forward_only:
        on_kernel_device = resolve_device(device).type == "cuda"
        config = config.replace(
            use_pallas=False,
            use_pallas_grad=config.use_pallas_grad or on_kernel_device,
            grad_regen=config.grad_regen or on_kernel_device,
        )
    if config.spp_chunk == 0:
        max_chunk = pick(None, config).max_chunk
        if config.spp > max_chunk:
            config = config.replace(spp_chunk=max_chunk)
    return config


def fit_config(config: RenderConfig, device=None) -> RenderConfig:
    """The config ``fit`` differentiates on ``device`` (CUDA unless named):
    ``grad_safe_config``'s, and on CUDA a config left on the plain route
    gets the fused gradient kernels, as the JAX ``fit`` does on the TPU
    (its spp chunk stays the one the plain route's budget picked)."""
    dev = resolve_device(device)
    config = grad_safe_config(config, dev)
    if dev.type == "cuda" and pick(None, config).name == PLAIN:
        config = config.replace(use_pallas_grad=True)
    return config


def camera_grad_config(config: RenderConfig, device=None) -> RenderConfig:
    """``grad_safe_config`` for a gradient in the camera's leaves: rays from
    the differentiable ``generate_rays`` (``camera_grad``), so neither the
    regeneration kernels nor raygen, which detach the camera."""
    return grad_safe_config(config.replace(camera_grad=True), device)


def plain_config(config: RenderConfig) -> RenderConfig:
    """``config`` on the plain route: every kernel flag cleared."""
    return config.replace(use_pallas=False, use_pallas_grad=False, use_pallas_hits=False)
