"""Forward rendering (counterpart of the JAX package's ``render.py``,
forward paths only).

Two routes, chosen by ``RenderConfig.use_pallas`` as in the JAX package:

* ``use_pallas=True`` (every preset): the persistent kernel renders a whole
  pixel block and all its samples in one launch
  (``ops/persistent.py:render_block_persistent``) — the CUDA kernel on a
  CUDA tensor, its plain version on a CPU tensor.
* ``use_pallas=False``: the plain wavefront — every live ray advances one
  bounce per step, materials resolved with masked selects, in the JAX jnp
  path's formulation (matmul-expanded intersection).

All randomness is keyed by global (pixel, sample) ids, so which lane or
chunk renders a sample never changes it.  There is no ``jit``: the JAX
package's ``lax.scan`` loops are Python loops here.
"""

from __future__ import annotations

import torch

from .camera import generate_rays
from .ops.intersect import Hit, intersect_scene
from .ops.materials import scatter, scatter_attrs, sky_color
from .ops.persistent import (
    GPU_BANKS,
    bank_geometry,
    camera_constants,
    render_block_persistent,
)
from .ops.plane import ray_plane_intersection
from .ops.sampling import bounce_noise, camera_jitter, ray_keys
from .types import Camera, RenderConfig, RenderState, Scene, resolve_device


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
            ph = ray_plane_intersection(
                o, d, scene.plane[:3], scene.plane[3], config.t_min, config.t_max
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
            q = torch.clamp(torch.amax(tp, dim=-1), 0.05, 1.0)
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


def render_pixel_block(scene, camera, config, key, pixel_ids, sample_offset, n_samples):
    """Radiance SUM [len(pixel_ids), 3] over ``n_samples`` consecutive sample
    ids for an explicit block of pixels.  The plain wavefront folds samples
    in ``spp_chunk``-sized steps to bound live memory."""
    if config.use_pallas:
        # Samples loop inside the kernel: no spp chunking.
        return _render_block_pallas(
            scene, camera, config, key, pixel_ids, sample_offset, n_samples
        )
    p = pixel_ids.shape[0]
    chunk = min(config.spp_chunk or n_samples, n_samples)
    if n_samples % chunk:
        # spp_chunk is an upper bound: use the largest divisor that fits.
        chunk = next(c for c in range(chunk, 0, -1) if n_samples % c == 0)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=pixel_ids.device)
    for i in range(n_samples // chunk):
        off = sample_offset + i * chunk
        pids = pixel_ids.repeat(chunk)
        sids = (off + torch.arange(chunk, device=pixel_ids.device)).repeat_interleave(p)
        rad = render_pixels(scene, camera, config, key, pids, sids)
        acc = acc + torch.sum(rad.reshape(chunk, p, 3), dim=0)
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
