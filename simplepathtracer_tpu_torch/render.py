"""Rendering (counterpart of the JAX package's ``render.py``, hard paths).

Three routes, chosen by the config's flags as in the JAX package:

* ``use_pallas=True`` (every preset): the persistent kernel renders a whole
  pixel block and all its samples in one launch
  (``ops/persistent.py:render_block_persistent``) — the CUDA kernel on a
  CUDA tensor, its plain version on a CPU tensor.  Forward only.
* ``use_pallas_grad`` with ``grad_regen``: the regeneration gradient
  kernels (``ops/grad_regen.py``), streamed over spp chunks when the
  packed winner indices fit ``_IDX_PLANE_BUDGET``.  Differentiable.
* otherwise the plain wavefront — every live ray advances one bounce per
  step, materials resolved with masked selects, in the JAX jnp path's
  formulation (matmul-expanded intersection).  Differentiable by autograd,
  with JAX's gradient rules at ties.

``grad_safe_config`` picks the gradient route for a device.

All randomness is keyed by global (pixel, sample) ids, so which lane or
chunk renders a sample never changes it.  There is no ``jit``: the JAX
package's ``lax.scan`` loops are Python loops here.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .camera import generate_rays
from .ops.intersect import Hit, intersect_scene
from .ops.materials import scatter, scatter_attrs, sky_color
from .ops.grad_regen import (
    IDX_PACK,
    IDX_PACK_MAX_SPHERES,
    render_block_grad_regen,
    render_block_grad_regen_stream,
)
from .ops.persistent import (
    GPU_BANKS,
    bank_geometry,
    camera_constants,
    render_block_persistent,
)
from .ops.plane import ray_plane_intersection
from .ops.sampling import bounce_noise, camera_jitter, ray_keys
from .types import Camera, RenderConfig, RenderState, Scene, resolve_device


# Rays differentiated per spp chunk on the plain (autograd) path: the JAX
# package's value, which bounds the per-bounce residuals autograd keeps.
_GRAD_RAY_BUDGET = 2_000_000
# Lane-iterations (spp x pixels x max_depth) per spp chunk on the regen
# gradient path.  A chunk's backward holds its 25 residual planes and 9
# cotangent planes, 136 B per lane-iteration: 200M x 136 B = 27.2 GB, a
# third of an H100's 80 GB, beside the packed winner indices (below) and
# the caller's tensors.  At the cover frame (1200x800, depth 10) it picks
# 20-spp chunks (n_iter 207, 27.0 GB).  A larger chunk saves only launches:
# every kernel's work and traffic grow with the chunk.
_GRAD_ITER_BUDGET_REGEN = 200_000_000
# Bytes of packed winner indices (4 B per 3 lane-iterations) the streamed
# route may keep across all spp: 24 GiB on an H100's 80 GB, beside one
# chunk's 27 GB of planes.  At the cover frame that holds
# 3 x 24 GiB / (4 B x 960,000 x 10) = 2013 spp; beyond, the checkpointed
# stream re-records each chunk's indices in the backward.
_IDX_PLANE_BUDGET = 24 << 30


def stream_capacity_spp(config: RenderConfig, scene) -> int:
    """Largest spp whose packed winner indices fit ``_IDX_PLANE_BUDGET``
    for this (config, scene) -- the gate ``render_pixel_block`` applies.
    0 when the scene's table is too large for the 10-bit code."""
    if scene.num_spheres > IDX_PACK_MAX_SPHERES:
        return 0
    per_spp = 4 * config.num_pixels * max(1, config.max_depth)
    return int(IDX_PACK * _IDX_PLANE_BUDGET // per_spp)


def grad_safe_config(config: RenderConfig, device=None) -> RenderConfig:
    """A config for differentiating on ``device`` (CUDA unless named).

    The persistent kernel is forward only, so ``use_pallas`` is cleared.
    On CUDA a ``use_pallas`` preset keeps its speed intent through the
    regeneration gradient kernels (``use_pallas_grad`` + ``grad_regen``);
    on the CPU it takes the plain autograd path, as the JAX package does
    off the TPU.  Without an ``spp_chunk``, one is picked that keeps a
    chunk's differentiated work near the route's budget.
    """
    if config.use_pallas:
        on_kernel_device = resolve_device(device).type == "cuda"
        config = config.replace(
            use_pallas=False,
            use_pallas_grad=config.use_pallas_grad or on_kernel_device,
            grad_regen=config.grad_regen or on_kernel_device,
        )
    if config.spp_chunk == 0:
        if config.use_pallas_grad and config.grad_regen:
            max_chunk = _GRAD_ITER_BUDGET_REGEN // (
                config.num_pixels * max(1, config.max_depth)
            )
        else:
            max_chunk = _GRAD_RAY_BUDGET // config.num_pixels
        max_chunk = max(1, max_chunk)
        if config.spp > max_chunk:
            config = config.replace(spp_chunk=max_chunk)
    return config


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)), whose gradient
    splits 0.5/0.5 where x equals a bound (torch.clamp passes it whole)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def trace_rays(origins, dirs, keys, scene: Scene, config: RenderConfig):
    """Trace a batch of rays to completion (hard, non-stochastic bounce).
    Returns radiance [N, 3]; rays alive after ``max_depth`` bounces are
    black."""
    n = origins.shape[0]
    o, d = origins, dirs
    tp = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    for b in range(config.max_depth):
        unif = bounce_noise(keys, b)
        hit = intersect_scene(o, d, scene, config.t_min, config.t_max)
        if scene.plane is None:
            new_d, att, scattered = scatter(d, hit, scene, unif)
        else:
            # Sphere scan + Lambertian ground plane; the plane overrides the
            # winner where it is nearer.
            # The plane normal is not a differentiable parameter (offset and
            # albedo are): detached, as in the JAX package's jnp path.
            ph = ray_plane_intersection(
                o, d, scene.plane[:3].detach(), scene.plane[3],
                config.t_min, config.t_max,
            )
            pw = ph.hit & (ph.t < hit.t)
            hit = Hit(
                t=torch.where(pw, ph.t, hit.t),
                index=hit.index,
                hit=hit.hit | pw,
                point=torch.where(pw[:, None], ph.point, hit.point),
                normal=torch.where(pw[:, None], ph.normal, hit.normal),
            )
            i = hit.index
            mat = torch.where(pw, 0, scene.material[i])
            alb = torch.where(pw[:, None], scene.plane[None, 4:7], scene.albedo[i])
            fz = torch.where(pw, 0.0, scene.fuzz[i])
            io = torch.where(pw, 1.0, scene.ior[i])
            new_d, att, scattered = scatter_attrs(d, hit.normal, mat, alb, fz, io, unif)

        miss = alive & ~hit.hit
        rad = rad + tp * sky_color(d, scene.sky_lo, scene.sky_hi) * miss[:, None]
        live = alive & hit.hit
        surviving = live & scattered
        tp = torch.where(surviving[:, None], tp * att, tp)
        o = torch.where(live[:, None], hit.point, o)
        d = torch.where(surviving[:, None], new_d, d)
        if config.rr_start_depth and b >= config.rr_start_depth:
            # Russian roulette: unbiased early termination by throughput.
            # jnp.clip(jnp.max(tp, -1), 0.05, 1.0) with JAX's tie rules: the
            # max splits its gradient evenly over tied channels (as amax
            # does), the clip's maximum/minimum split it 0.5/0.5 at a bound.
            q = _clip(torch.amax(tp, dim=-1), 0.05, 1.0)
            surviving = surviving & ~(unif[:, 6] >= q)
            tp = torch.where(surviving[:, None], tp / q[:, None], tp)
        alive = surviving
    return rad


def render_pixels(scene, camera, config, key, pixel_ids, sample_ids):
    """Radiance [N, 3] for explicit (pixel, sample) pairs."""
    keys = ray_keys(key, pixel_ids, sample_ids)
    jit4 = camera_jitter(keys)
    origins, dirs = generate_rays(camera, config.width, config.height, keys.pixel, jit4)
    return trace_rays(origins, dirs, keys, scene, config)


def _persistent_args(scene, camera, config):
    """Sphere tables, sky and camera blocks of the persistent kernel."""
    tables = (
        scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2],
        scene.radii, scene.radii * scene.radii,
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.material.to(torch.int32), scene.fuzz, scene.ior,
    )
    tables = tuple(t.contiguous() for t in tables)
    sky6 = torch.cat([scene.sky_lo, scene.sky_hi]).to(torch.float32)
    cam19 = camera_constants(camera, config.width, config.height)
    return tables, sky6, cam19


def _render_block_pallas(
    scene, camera, config, key, pixel_ids, sample_offset, n_samples,
    return_counts=False,
):
    """Persistent-kernel radiance sum for a pixel block (forward fast path)."""
    tables, sky6, cam19 = _persistent_args(scene, camera, config)
    return render_block_persistent(
        pixel_ids, tables, sky6, cam19, key, sample_offset,
        n_samples=n_samples, max_depth=config.max_depth,
        width=config.width, height=config.height,
        t_min=config.t_min, t_max=config.t_max,
        rr_start_depth=config.rr_start_depth,
        return_counts=return_counts, plane7=scene.plane,
    )


def _balanced_perm(counts, n_banks: int = GPU_BANKS):
    """Cost-balancing pixel permutation for the persistent kernel's lanes.

    ``counts[q]``: measured bounce iterations of the pixel at position q
    (from a probe pass).  The kernel gives position q to bank q // n_lanes,
    lane q % n_lanes.  Snake assignment over the cost ranking: bank k takes
    ranks [k * n_lanes, (k + 1) * n_lanes), laid onto lanes in alternating
    direction, so every lane gets one pixel from each cost stratum.  The
    sort is stable, as jnp.argsort is: integer counts tie constantly, and
    the permutation must not depend on how ties fall.
    """
    p = counts.shape[0]
    n_banks, n_lanes = bank_geometry(p, n_banks)
    order = torch.argsort(-counts, stable=True)
    q = torch.arange(p, device=counts.device)
    k = torch.div(q, n_lanes, rounding_mode="floor")
    lane = q % n_lanes
    # Snake only over full banks (a partial final bank keeps identity order
    # so rank(q) stays a bijection onto [0, p)).
    use_snake = ((k % 2) == 1) & ((k + 1) * n_lanes <= p)
    rank = k * n_lanes + torch.where(use_snake, n_lanes - 1 - lane, lane)
    return order[rank]


def _requires_grad(scene) -> bool:
    return any(
        t is not None and t.requires_grad
        for t in (scene.centers, scene.radii, scene.albedo, scene.fuzz,
                  scene.ior, scene.sky_lo, scene.sky_hi, scene.plane)
    )


def render_pixel_block(scene, camera, config, key, pixel_ids, sample_offset, n_samples):
    """Radiance SUM [len(pixel_ids), 3] over ``n_samples`` consecutive sample
    ids for an explicit block of pixels.  Outside the persistent kernel,
    samples are folded in ``spp_chunk``-sized steps to bound live memory;
    under autograd each step is recomputed in the backward
    (``torch.utils.checkpoint``), or the regen route streams its chunks."""
    if config.use_pallas:
        # Samples loop inside the kernel: no spp chunking.
        return _render_block_pallas(
            scene, camera, config, key, pixel_ids, sample_offset, n_samples
        )
    use_regen = config.use_pallas_grad and config.grad_regen
    p = pixel_ids.shape[0]
    chunk = min(config.spp_chunk or n_samples, n_samples)
    if n_samples % chunk:
        # spp_chunk is an upper bound: use the largest divisor that fits.
        chunk = next(c for c in range(chunk, 0, -1) if n_samples % c == 0)
    n_steps = n_samples // chunk
    banks = config.grad_regen_banks or None

    if use_regen and n_steps > 1 and config.grad_regen_stream:
        if scene.num_spheres <= IDX_PACK_MAX_SPHERES:
            # Streamed-idx: one idx-only forward over all samples, then per
            # chunk a scan-free re-forward + backward.  Past the idx-plane
            # budget, the checkpointed stream re-records each chunk's
            # indices in the backward with the same kernel.
            fits = 4 * p * n_samples * config.max_depth <= IDX_PACK * _IDX_PLANE_BUDGET
            return render_block_grad_regen_stream(
                scene, camera, config, key, pixel_ids, sample_offset,
                n_samples, chunk, n_banks=banks, checkpoint_idx=not fits,
            )

    def step(off):
        if use_regen:
            # One recording forward per chunk; its planes serve the backward.
            return render_block_grad_regen(
                scene, camera, config, key, pixel_ids, off, chunk, n_banks=banks
            )
        pids = pixel_ids.repeat(chunk)
        sids = (off + torch.arange(chunk, device=pixel_ids.device)).repeat_interleave(p)
        rad = render_pixels(scene, camera, config, key, pids, sids)
        return torch.sum(rad.reshape(chunk, p, 3), dim=0)

    remat = n_steps > 1 and torch.is_grad_enabled() and _requires_grad(scene)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=pixel_ids.device)
    for i in range(n_steps):
        off = sample_offset + i * chunk
        acc = acc + (checkpoint(step, off, use_reentrant=False) if remat else step(off))
    return acc


def render_sample_batch(scene, camera, config, key, sample_offset, n_samples,
                        pixel_ids=None):
    """Radiance SUM [P, 3] over ``n_samples`` consecutive sample ids for every
    pixel (row i is pixel ``pixel_ids[i]``; row-major when None)."""
    if pixel_ids is None:
        pixel_ids = torch.arange(config.num_pixels, device=scene.device)
    return render_pixel_block(
        scene, camera, config, key, pixel_ids, sample_offset, n_samples
    )


def init_state(config: RenderConfig, key, device=None) -> RenderState:
    """Empty accumulation state on ``device`` (the render's device)."""
    return RenderState(
        accum=torch.zeros(
            (config.height, config.width, 3), dtype=torch.float32,
            device=resolve_device(device),
        ),
        sample_count=0,
        next_key=torch.as_tensor(key, dtype=torch.int64).cpu(),
    )


def accumulate(
    state: RenderState, scene: Scene, camera: Camera, config: RenderConfig,
    n_samples: int,
) -> RenderState:
    """Fold ``n_samples`` more spp into the state.  Sample ids continue from
    ``state.sample_count``, so a resumed render is bit-identical to an
    uninterrupted one."""
    probe = config.balance_probe_spp if config.use_pallas else 0
    if probe and n_samples > probe:
        return _accumulate_balanced(state, scene, camera, config, n_samples, probe)

    chunk = min(config.spp_chunk or n_samples, n_samples)
    if n_samples % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if n_samples % c == 0)
    accum = state.accum
    for i in range(n_samples // chunk):
        off = state.sample_count + i * chunk
        batch = render_sample_batch(scene, camera, config, state.next_key, off, chunk)
        accum = accum + batch.reshape(config.height, config.width, 3)
    return RenderState(
        accum=accum,
        sample_count=state.sample_count + n_samples,
        next_key=state.next_key,
    )


def _accumulate_balanced(state, scene, camera, config, n_samples, probe):
    """Probe-then-balance accumulation (persistent kernel).

    The probe renders ``probe`` spp in image order and measures per-pixel
    bounce iterations; the remaining spp render with pixels assigned to
    lanes in cost-balanced snake order (``_balanced_perm``).  Pixel values
    are bit-identical to the unbalanced two-chunk schedule: lane placement
    changes no sample.
    """
    h, w = config.height, config.width
    pixel_ids = torch.arange(config.num_pixels, device=scene.device)
    batch, counts = _render_block_pallas(
        scene, camera, config, state.next_key, pixel_ids,
        state.sample_count, probe, return_counts=True,
    )
    accum = state.accum + batch.reshape(h, w, 3)
    perm = _balanced_perm(counts)
    rad = _render_block_pallas(
        scene, camera, config, state.next_key, perm,
        state.sample_count + probe, n_samples - probe,
    )
    inv = torch.argsort(perm)
    accum = accum + rad[inv].reshape(h, w, 3)
    return RenderState(
        accum=accum,
        sample_count=state.sample_count + n_samples,
        next_key=state.next_key,
    )


def render(scene: Scene, camera: Camera, config: RenderConfig, key) -> torch.Tensor:
    """One-shot render on the scene's device: [H, W, 3] gamma-corrected
    float image in [0, 1]."""
    state = init_state(config, key, device=scene.device)
    state = accumulate(state, scene, camera, config, config.spp)
    return state.image(config.gamma)
