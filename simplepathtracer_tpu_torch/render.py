"""Rendering (counterpart of the JAX package's ``render.py``).

Routes, chosen by the config's flags as in the JAX package:

* ``render`` with ``use_pallas=True`` (every preset): the persistent kernel
  renders a whole pixel block and all its samples in one launch
  (``ops/persistent.py:render_block_persistent``) -- the CUDA kernel on a
  CUDA tensor, its plain version on a CPU tensor.  Forward only.
* ``trace_rays`` / ``render_pixels`` (explicit rays) with ``use_pallas``:
  ``trace_rays_pallas``, one launch of the bounce-step kernel per bounce
  (``ops/bounce_step.py``).  Forward only.
* ``use_pallas_grad`` with ``grad_regen``: the regeneration gradient
  kernels (``ops/grad_regen.py``), streamed over spp chunks when the
  packed winner indices fit ``_IDX_PLANE_BUDGET``.  Differentiable.
* ``use_pallas_grad`` alone, or with ``camera_grad``: the per-bounce fused
  gradient kernels (``ops/grad.py``) on explicit rays, sphere scenes only.
  Camera rays come from the raygen kernel, or under ``camera_grad`` from
  the differentiable ``generate_rays``, whose (origin, direction)
  cotangents the fused backward returns.  Differentiable.
* ``use_pallas_hits`` (hard silhouettes, sphere scenes): the eager bounce
  below with the closest hit from the closest-hit-attributes kernel
  (``ops/closest_hit.py``), detached, and the table's gradient reattached
  to the winner's attributes (``ops/table_gather.py:attach_attr_columns``,
  whose backward runs the bucket kernel).  Differentiable.
* otherwise the plain wavefront -- every live ray advances one bounce per
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
from .ops import bounce_step as _bs
from .ops import closest_hit as _ch
from .ops import intersect
from .ops.intersect import (
    SIL_P_FLOOR,
    Hit,
    crossing_scale,
    grad_capped_sqrt,
    hit_from_gathered,
    intersect_scene,
    intersect_scene_soft,
    silhouette_logit,
    silhouette_scale,
    validity_scale,
)
from .ops.materials import scatter, scatter_attrs, sky_color
from .ops.grad import trace_pixels_fused, trace_rays_fused
from .ops.grad_regen import (
    IDX_PACK,
    IDX_PACK_MAX_SPHERES,
    render_block_grad_regen,
    render_block_grad_regen_stream,
    scene_inputs,
)
from .ops.persistent import (
    GPU_BANKS,
    bank_geometry,
    camera_constants,
    render_block_persistent,
)
from .ops.plane import ray_plane_intersection
from .ops.sampling import bounce_noise, camera_jitter, crossing_noise, ray_keys
from .ops.table_gather import attach_attr_columns, pack_tables
from .types import Camera, RenderConfig, RenderState, Scene, resolve_device


# Rays differentiated per spp chunk on the plain (autograd) path: the JAX
# package's value, which bounds the per-bounce residuals autograd keeps.
_GRAD_RAY_BUDGET = 2_000_000
# Ray-bounces (rays x max_depth) per spp chunk on the fused gradient route
# (ops/grad.py).  Its backward keeps, per ray and bounce, the entry state
# (10 planes) and the winner index, 44 B (soft silhouettes: and the blocker
# index, 48 B), where the JAX kernels keep 84 B (104): the port reads the
# winner's attributes back from the table by index.  500M ray-bounces hold
# 22-24 GB of them, under a third of an H100's 80 GB, beside what autograd
# keeps of generate_rays under camera gradients (~100 B per ray) and the
# backward's carried and attribute cotangents (~90 B per ray).  At the
# cover frame (1200x800, depth 10) that allows 52-spp chunks: the decoupled
# camera fit differentiates its 50 spp in one chunk, with no remat.
_GRAD_RAY_BOUNCE_BUDGET_FUSED = 500_000_000
# Lane-iterations (spp x pixels x max_depth) per spp chunk on the regen
# gradient path.  A chunk's backward holds its 25 residual planes and 9
# cotangent planes, 136 B per lane-iteration: 200M x 136 B = 27.2 GB, a
# third of an H100's 80 GB, beside the packed winner indices (below) and
# the caller's tensors.  Soft silhouettes add 5 blocker planes and 4
# blocker cotangent planes, 172 B: 200M x 172 B = 34.4 GB, under half of
# it.  At the cover frame (1200x800, depth 10) it picks 20-spp chunks
# (n_iter 207: 27.0 GB hard, 34.2 GB soft); the soft fit's decoupled
# gradient differentiates 50 spp in 10-spp chunks (n_iter 108, 17.8 GB).
# A larger chunk saves only launches: every kernel's work and traffic grow
# with the chunk.
_GRAD_ITER_BUDGET_REGEN = 200_000_000
# Bytes of packed winner indices (4 B per 3 lane-iterations; soft: the
# blocker indices too, 8 B) the streamed route may keep across all spp:
# 24 GiB on an H100's 80 GB, beside one chunk's 27-34 GB of planes.  At the
# cover frame that holds 3 x 24 GiB / (4 B x 960,000 x 10) = 2013 spp
# (soft: 1006); beyond, the checkpointed stream re-records each chunk's
# indices in the backward.
_IDX_PLANE_BUDGET = 24 << 30


def stream_capacity_spp(config: RenderConfig, scene) -> int:
    """Largest spp whose packed winner indices fit ``_IDX_PLANE_BUDGET``
    for this (config, scene) -- the gate ``render_pixel_block`` applies.
    0 when the scene's table is too large for the 10-bit code."""
    if scene.num_spheres > IDX_PACK_MAX_SPHERES:
        return 0
    per_spp = _idx_planes(config) * 4 * config.num_pixels * max(1, config.max_depth)
    return int(IDX_PACK * _IDX_PLANE_BUDGET // per_spp)


def _idx_planes(config: RenderConfig) -> int:
    """Packed index planes the streamed route keeps: the winners, and under
    soft silhouettes the blockers."""
    return 2 if config.silhouette_softness > 0.0 else 1


def grad_safe_config(config: RenderConfig, device=None) -> RenderConfig:
    """A config for differentiating on ``device`` (CUDA unless named).

    The persistent and bounce-step kernels are forward only, so
    ``use_pallas`` is cleared.  On CUDA a ``use_pallas`` preset keeps its
    speed intent through the regeneration gradient kernels
    (``use_pallas_grad`` + ``grad_regen``; the JAX package also sets
    ``use_pallas_hits``, which no route then reads); on the CPU it takes
    the plain autograd path, as the JAX package does off the TPU.  A
    ``use_pallas_hits`` config keeps its flag.  Without an ``spp_chunk``,
    one is picked that keeps a chunk's differentiated work near the route's
    budget: the regeneration
    kernels', the fused kernels' (``use_pallas_grad`` without
    ``grad_regen``, or with ``camera_grad``, which skips the regeneration
    kernels), or the plain path's.
    """
    if config.use_pallas:
        on_kernel_device = resolve_device(device).type == "cuda"
        config = config.replace(
            use_pallas=False,
            use_pallas_grad=config.use_pallas_grad or on_kernel_device,
            grad_regen=config.grad_regen or on_kernel_device,
        )
    if config.spp_chunk == 0:
        ray_bounces = config.num_pixels * max(1, config.max_depth)
        if _uses_regen(config):
            max_chunk = _GRAD_ITER_BUDGET_REGEN // ray_bounces
        elif config.use_pallas_grad:
            max_chunk = _GRAD_RAY_BOUNCE_BUDGET_FUSED // ray_bounces
        else:
            max_chunk = _GRAD_RAY_BUDGET // config.num_pixels
        max_chunk = max(1, max_chunk)
        if config.spp > max_chunk:
            config = config.replace(spp_chunk=max_chunk)
    return config


def _uses_regen(config: RenderConfig) -> bool:
    """The regeneration kernels serve the gradient: they consume pixel ids
    and detach the camera, so ``camera_grad`` excludes them."""
    return config.use_pallas_grad and config.grad_regen and not config.camera_grad


def _uses_raygen(scene, config: RenderConfig) -> bool:
    """The fused route makes a sphere scene's camera rays with the raygen
    kernel, the camera detached, unless ``camera_grad`` asks for the
    differentiable ``generate_rays``."""
    return (config.use_pallas_grad and not config.use_pallas and scene.plane is None
            and not config.camera_grad)


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)), whose gradient
    splits 0.5/0.5 where x equals a bound (torch.clamp passes it whole)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _soft_ratio(o, d, hit, alive, scene, soft, t_min, wc3, wr, blk,
                pw=None, ph_t=None, cross_valid=None):
    """den / stop_grad(den), 1 in value: the two-sided soft-silhouette
    estimator's detached ratio of one bounce (the JAX package's jnp path).

    den = max(We Ve - [blocker valid] min(We, Wb) min(Ve, Vb), SIL_P_FLOOR),
    times, on plane scenes, the crossing coin's probability qf of the
    realized plane-vs-sphere outcome.  Its gradient is the realized scan
    outcome's score: in expectation the two-sided visibility derivative."""
    oc = wc3 - o
    tcw = torch.sum(oc * d, -1)
    discw = wr * wr - (torch.sum(oc * oc, -1) - tcw * tcw)
    xsw = _clip(discw / (silhouette_scale(soft, wr) + 1e-12), -30.0, 30.0)
    sphere_win = alive & hit.hit
    if pw is not None:
        sphere_win = sphere_win & ~pw
    we = torch.where(sphere_win, 1.0 / (1.0 + torch.exp(-xsw)), 1.0)
    # Winner validity V = P(t_raw beats the t_min coin), from the winner's
    # attributes; the realized t is max(t_raw, t_min).
    sqw = grad_capped_sqrt(torch.maximum(discw, discw.new_tensor(1e-12)),
                           silhouette_scale(soft, wr))
    tnw = tcw - sqw
    t_raw_w = torch.where(tnw > t_min, tnw, tcw + sqw)
    v_w = torch.sigmoid(_clip((t_raw_w - t_min) / (validity_scale(soft, wr) + 1e-12),
                              -30.0, 30.0))
    ve = torch.where(sphere_win, v_w, 1.0)
    bi = torch.clamp(blk, min=0)
    bc = scene.centers[bi]
    brr = scene.radii[bi]
    ocb = bc - o
    tcb = torch.sum(ocb * d, -1)
    discb = brr * brr - (torch.sum(ocb * ocb, -1) - tcb * tcb)
    xsb = _clip(discb / (silhouette_scale(soft, brr) + 1e-12), -30.0, 30.0)
    sqb = torch.sqrt(torch.maximum(discb, discb.new_tensor(1e-12)))
    tnb = tcb - sqb
    t_raw_b = torch.where(tnb > t_min, tnb, tcb + sqb)
    t_b = torch.maximum(t_raw_b, t_raw_b.new_tensor(t_min))
    v_b = torch.sigmoid(_clip((t_raw_b - t_min) / (validity_scale(soft, brr) + 1e-12),
                              -30.0, 30.0))
    # The blocker counts where it lies strictly in front of the final
    # winner: p = We Ve - min(We, Wb) min(Ve, Vb) over the shared coins.
    bvalid = (blk >= 0) & alive & (t_b < hit.t)
    wb = torch.where(bvalid, 1.0 / (1.0 + torch.exp(-xsb)), 0.0)
    vb = torch.where(bvalid, v_b, 1.0)
    blk_term = torch.where(bvalid, torch.minimum(we, wb) * torch.minimum(ve, vb), 0.0)
    qf = None
    if ph_t is not None:
        # Crossing factor: qx = P(sphere beats plane) from the
        # differentiable t's.  Where the plane won, P(plane wins) is taken
        # as sigmoid of the negated argument, not 1 - qx: 1 - qx rounds to
        # 0 once the sphere leads by ~16.7 sigma_x, and a realized plane
        # win would then give den / stop_grad(den) = 0 / 0.
        t_w = torch.maximum(t_raw_w, t_raw_w.new_tensor(t_min))
        sigx = crossing_scale(soft, wr)
        arg = _clip((ph_t - t_w) / (sigx + 1e-12), -30.0, 30.0)
        # Where the plane beat an in-band accepted sphere, that sphere takes
        # the single blocker slot (as in the kernels): no front blocker.
        steal = pw & cross_valid & ((t_w - ph_t).detach() < 30.0 * sigx.detach())
        blk_term = torch.where(steal, 0.0, blk_term)
        qf = torch.where(pw, torch.sigmoid(-arg), torch.sigmoid(arg))
        qf = torch.where(cross_valid & alive, qf, 1.0)
    # Floor only the acceptance probability: the crossing factor's score
    # is bounded and stays outside the floor.
    den = torch.maximum(we * ve - blk_term, we.new_tensor(SIL_P_FLOOR))
    if qf is not None:
        den = den * qf
    return den / den.detach()


def bounce_step_call(scene, keys, config) -> _bs.BounceCall:
    """The bounce-step kernel's tables and options for ``scene`` under
    ``config``, keyed by ``keys`` (values only)."""
    inputs = scene_inputs(scene)
    return _bs.bounce_call(
        inputs[:11], inputs[11], inputs[12], keys.k0, keys.k1, t_min=config.t_min,
        t_max=config.t_max, rr_start_depth=config.rr_start_depth,
    )


def trace_rays_pallas(origins, dirs, keys, scene: Scene, config: RenderConfig):
    """Forward-only radiance [N, 3] of explicit rays: ``max_depth`` launches
    of the bounce-step kernel (``ops/bounce_step.py``) on SoA state, the JAX
    package's ``trace_rays_pallas``.  Its arithmetic is the TPU bounce
    kernel's (direct |oc|^2, lerped state updates), not the eager bounce's;
    soft silhouettes are not read (hard scan).  Raises when autograd would
    need a gradient through it: a ray or a scene leaf requires one."""
    if torch.is_grad_enabled() and (
        origins.requires_grad or dirs.requires_grad or _requires_grad(scene)
    ):
        raise RuntimeError(
            "trace_rays_pallas (use_pallas) is forward only: clear use_pallas "
            "(grad_safe_config) to differentiate, or run under torch.no_grad()"
        )
    call = bounce_step_call(scene, keys, config)
    state = _bs.initial_state(origins, dirs)
    pix = keys.pixel.to(torch.int32).contiguous()
    samp = keys.sample.to(torch.int32).contiguous()
    for b in range(config.max_depth):
        state = _bs.bounce_step(call, state, pix, samp, b)
    return state[9:12].T.contiguous()


def trace_rays(origins, dirs, keys, scene: Scene, config: RenderConfig):
    """Trace a batch of rays to completion.  Returns radiance [N, 3]; rays
    alive after ``max_depth`` bounces are black.

    With ``silhouette_softness`` > 0 the bounce is the JAX package's
    two-sided soft-silhouette estimator: a stochastic-transparency scan
    (acceptance and validity coins, the strongest rejected front blocker),
    a stochastic plane-vs-sphere crossing coin on plane scenes, and the
    detached ratio ``_soft_ratio`` on the entry throughput.

    The routes, in the JAX package's order: ``use_pallas`` goes to the
    forward-only ``trace_rays_pallas``.  The fused and hits kernels are
    sphere-only, so a plane scene clears ``use_pallas_grad`` and
    ``use_pallas_hits``; the closest-hit kernel has no stochastic scan, so
    soft silhouettes clear ``use_pallas_hits``.  Then ``use_pallas_grad``
    goes through the fused gradient kernels
    (``ops/grad.py:trace_rays_fused``), and ``use_pallas_hits`` takes the
    bounce below with the closest hit from the closest-hit-attributes
    kernel."""
    if config.use_pallas:
        return trace_rays_pallas(origins, dirs, keys, scene, config)
    if scene.plane is not None and (config.use_pallas_grad or config.use_pallas_hits):
        config = config.replace(use_pallas_grad=False, use_pallas_hits=False)
    if config.silhouette_softness > 0.0 and config.use_pallas_hits:
        config = config.replace(use_pallas_hits=False)
    if config.use_pallas_grad:
        return trace_rays_fused(origins, dirs, keys, scene, config)
    if config.use_pallas_hits:
        # The table's float attributes, differentiable, and its values for
        # the kernel, padded into the kernel's table once for every bounce.
        attr9 = pack_tables(scene)
        hit_tables = tuple(t.detach() for t in scene_inputs(scene)[:11])
        hit_tab = _ch.sphere_table(hit_tables)
    n = origins.shape[0]
    soft = config.silhouette_softness
    fresnel = bool(soft > 0.0 and intersect.SIL_FRESNEL)
    o, d = origins, dirs
    tp = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    # The chain's previous sphere winner (-1: none), hard-gated in the scan.
    prev = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for b in range(config.max_depth):
        unif = bounce_noise(keys, b)
        widx = pw = ph_t = cross_valid = blk = None
        if config.use_pallas_hits:
            # The winner's index and attributes from the kernel, detached;
            # attach_attr_columns buckets their cotangents into the table by
            # the -1-masked index (a miss or dead ray buckets nowhere).
            idx, attr_vals, mat = _ch.closest_hit_attrs(
                o.detach(), d.detach(), alive, hit_tables, config.t_min, config.t_max,
                tab=hit_tab)
            cx, cy, cz, r, ar, ag, ab, fz, io = attach_attr_columns(attr9, idx, *attr_vals)
            hit = hit_from_gathered(
                o, d, torch.clamp(idx, min=0).to(torch.int64), idx >= 0,
                torch.stack([cx, cy, cz], -1), r, config.t_min, config.t_max,
            )
            new_d, att, scattered = scatter_attrs(
                d, hit.normal, mat, torch.stack([ar, ag, ab], -1), fz, io, unif)
        else:
            if soft > 0.0:
                uxw, uvw = crossing_noise(keys, b)
                hit, blk = intersect_scene_soft(
                    o, d, unif[:, 7], uvw, scene, config.t_min, config.t_max, soft,
                    prev_idx=prev,
                )
            else:
                hit = intersect_scene(o, d, scene, config.t_min, config.t_max)
            if scene.plane is None:
                new_d, att, scattered = scatter(d, hit, scene, unif, fresnel_score=fresnel)
                if soft > 0.0:
                    widx = torch.where(hit.hit, hit.index, -1)
            else:
                # Sphere scan + Lambertian ground plane; the plane overrides the
                # winner where it is nearer (soft: where it wins the crossing
                # coin).  The plane normal is not a differentiable parameter
                # (offset and albedo are): detached, as in the JAX package.
                ph = ray_plane_intersection(
                    o, d, scene.plane[:3].detach(), scene.plane[3],
                    config.t_min, config.t_max,
                )
                if soft > 0.0:
                    # The sphere beats the plane iff t_s < t_p + logit(ux) *
                    # sigma_x(r_winner).
                    thr_x = silhouette_logit(uxw) * crossing_scale(
                        soft, scene.radii[hit.index].detach())
                    pw = ph.hit & ~(hit.hit & (hit.t < ph.t + thr_x))
                    ph_t = ph.t
                    cross_valid = ph.hit & hit.hit
                else:
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
                new_d, att, scattered = scatter_attrs(d, hit.normal, mat, alb, fz, io, unif,
                                                      fresnel_score=fresnel)
                if soft > 0.0:
                    widx = torch.where(hit.hit & ~pw, hit.index, -1)
        if soft > 0.0:
            srat = _soft_ratio(
                o, d, hit, alive, scene, soft, config.t_min,
                scene.centers[hit.index], scene.radii[hit.index], blk,
                pw=pw, ph_t=ph_t, cross_valid=cross_valid,
            )
            tp = tp * srat[:, None]

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
        if soft > 0.0:
            prev = widx
    return rad


def render_pixels(scene, camera, config, key, pixel_ids, sample_ids):
    """Radiance [N, 3] for explicit (pixel, sample) pairs.  On the fused
    gradient route a sphere scene's camera rays come from the raygen kernel
    (the camera detached) unless ``camera_grad`` asks for the
    differentiable ``generate_rays``."""
    keys = ray_keys(key, pixel_ids, sample_ids)
    if _uses_raygen(scene, config):
        return trace_pixels_fused(camera, keys, scene, config)
    jit4 = camera_jitter(keys)
    origins, dirs = generate_rays(camera, config.width, config.height, keys.pixel, jit4)
    return trace_rays(origins, dirs, keys, scene, config)


def _persistent_args(scene, camera, config):
    """Sphere tables, sky and camera blocks of the persistent kernel."""
    tables = tuple(t.contiguous() for t in scene_inputs(scene)[:11])
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
    (from a probe pass).  The banked layout (the JAX kernel's) gives
    position q to bank q // n_lanes, lane q % n_lanes; the CUDA kernel
    fetches positions in order, so with its one bank the permutation hands
    out the costliest pixels first.  Snake assignment over the cost
    ranking: bank k takes ranks [k * n_lanes, (k + 1) * n_lanes), laid onto
    lanes in alternating direction, so every lane gets one pixel from each
    cost stratum.  The
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


def balanced_pixel_perm(scene, camera, config, key, probe_spp=2):
    """Cost-balanced pixel order for the gradient routes (``fit(balance=
    True)``): a probe of ``probe_spp`` spp through the persistent kernel
    (its plain version on the CPU) counts each pixel's bounce iterations,
    and ``_balanced_perm`` orders the pixels by them.  The probe runs under
    ``torch.no_grad()`` and its radiance is discarded; ``accumulate``
    balances itself through ``balance_probe_spp``."""
    pixel_ids = torch.arange(config.num_pixels, device=scene.device)
    pcfg = config.replace(use_pallas=True, use_pallas_grad=False, use_pallas_hits=False)
    with torch.no_grad():
        _, counts = _render_block_pallas(
            scene, camera, pcfg, key, pixel_ids, 0, probe_spp, return_counts=True
        )
    return _balanced_perm(counts)


def _requires_grad(scene, camera=None) -> bool:
    """Whether a scene leaf (or, given a camera, a camera leaf) needs a
    gradient."""
    leaves = [scene.centers, scene.radii, scene.albedo, scene.fuzz, scene.ior,
              scene.sky_lo, scene.sky_hi, scene.plane]
    if camera is not None:
        leaves += [camera.origin, camera.lookat, camera.vup, camera.vfov_deg,
                   camera.aperture, camera.focus_dist]
    return any(t is not None and t.requires_grad for t in leaves)


def render_pixel_block(scene, camera, config, key, pixel_ids, sample_offset, n_samples):
    """Radiance SUM [len(pixel_ids), 3] over ``n_samples`` consecutive sample
    ids for an explicit block of pixels.  Outside the persistent kernel,
    samples are folded in ``spp_chunk``-sized steps to bound live memory;
    under autograd each step is recomputed in the backward
    (``torch.utils.checkpoint``), or the regen route streams its chunks.
    The camera's leaves count as differentiated too, except on the routes
    that detach the camera (the regeneration kernels, the fused route's
    raygen).
    The JAX package's ``_coherent_pixel_order`` (pixel tiles for the TPU
    kernels' block skipping) is not ported: it changes no value, and a
    warp's 32 row-adjacent rays are coherent already."""
    if config.use_pallas:
        # Samples loop inside the kernel: no spp chunking.
        return _render_block_pallas(
            scene, camera, config, key, pixel_ids, sample_offset, n_samples
        )
    use_regen = _uses_regen(config)
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
            fits = (_idx_planes(config) * 4 * p * n_samples * config.max_depth
                    <= IDX_PACK * _IDX_PLANE_BUDGET)
            # A value-only pass keeps no words for a backward.
            keep = fits and torch.is_grad_enabled() and _requires_grad(scene)
            return render_block_grad_regen_stream(
                scene, camera, config, key, pixel_ids, sample_offset,
                n_samples, chunk, n_banks=banks, checkpoint_idx=not keep,
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

    # The camera's leaves count unless the route detaches the camera.
    camera_detached = use_regen or _uses_raygen(scene, config)
    remat = n_steps > 1 and torch.is_grad_enabled() and _requires_grad(
        scene, None if camera_detached else camera)
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
    float image in [0, 1].

    With ``use_pallas`` the persistent kernel ignores
    ``silhouette_softness`` and renders hard silhouettes, as the JAX
    package's persistent kernel does.  A soft image (stochastic acceptance
    at silhouettes, as a soft fit sees the scene) comes from the other
    routes: ``use_pallas=False``, or ``grad_safe_config``'s regen route."""
    state = init_state(config, key, device=scene.device)
    state = accumulate(state, scene, camera, config, config.spp)
    return state.image(config.gamma)
