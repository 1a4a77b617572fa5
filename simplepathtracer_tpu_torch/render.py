"""Rendering (counterpart of the JAX package's ``render.py``).

Which route a call takes -- the persistent kernel, the bounce-step kernel,
the regeneration or fused gradient kernels, the closest-hit kernels or the
plain wavefront -- and what each route carries is decided in ``routes.py``
(``routes.pick``, ``routes.CAPS``); the functions here run the route they
are given.  The plain wavefront advances every live ray one bounce per
step, materials resolved with masked selects, in the JAX jnp path's
formulation (matmul-expanded intersection), differentiable by autograd
with JAX's gradient rules at ties.

All randomness is keyed by global (pixel, sample) ids, so which lane or
chunk renders a sample never changes it.  There is no ``jit``: the JAX
package's ``lax.scan`` loops are Python loops here.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import routes, tracing
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
from .ops.grad_regen import render_block_grad_regen, render_block_grad_regen_stream, scene_inputs
from .ops.persistent import camera_constants, render_block_persistent
from .ops.plane import ray_plane_intersection
from .ops.sampling import bounce_noise, camera_jitter, crossing_noise, ray_keys
from .ops.table_gather import attach_attr_columns, pack_tables
from .types import Camera, RenderConfig, RenderState, Scene, resolve_device

# Samples of the cost probe that orders pixels for the persistent kernel's
# lanes (``balanced_pixel_perm``) and deals them to a mesh's tiles
# (``parallel.render_accum_sharded``).
PROBE_SPP = 2


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
    soft silhouettes are not read (hard scan).  Raises (``routes.check``)
    on an emissive scene, or where a ray or a scene leaf needs a gradient."""
    routes.check(routes.BOUNCE_STEP, scene, config, differentiates=torch.is_grad_enabled() and (
        origins.requires_grad or dirs.requires_grad or _requires_grad(scene)))
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
    detached ratio ``_soft_ratio`` on the entry throughput.  A scene with
    ``emission`` adds, at each live sphere hit, the throughput (after that
    ratio) times the winner's emission.

    The route is ``routes.pick``'s: ``trace_rays_pallas``,
    ``trace_rays_fused``, or the bounce below (``plain``; ``hits``: its
    closest hit from the closest-hit-attributes kernel)."""
    route = routes.pick(scene, config, entry=routes.RAYS).name
    if route == routes.BOUNCE_STEP:
        return trace_rays_pallas(origins, dirs, keys, scene, config)
    if route == routes.FUSED:
        return trace_rays_fused(origins, dirs, keys, scene, config)
    hits = route == routes.HITS
    if hits:
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
        if hits:
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
        if scene.emission is not None:
            # Emitted light at a live sphere hit (the plane emits nothing).
            lit = live if pw is None else live & ~pw
            rad = rad + tp * scene.emission[hit.index] * lit[:, None]
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
    """Radiance [N, 3] for explicit (pixel, sample) pairs.  On the
    ``fused_raygen`` route the camera rays come from the raygen kernel (the
    camera detached); every other route traces the differentiable
    ``generate_rays`` through ``trace_rays``."""
    raygen = routes.pick(scene, config, entry=routes.PIXELS).name == routes.FUSED_RAYGEN
    with tracing.span("spt.rays.camera"):
        keys = ray_keys(key, pixel_ids, sample_ids)
        if not raygen:
            jit4 = camera_jitter(keys)
            origins, dirs = generate_rays(camera, config.width, config.height, keys.pixel, jit4)
    if raygen:
        return trace_pixels_fused(camera, keys, scene, config)
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
        return_counts=return_counts, plane7=scene.plane, emission=scene.emission,
    )


def probe_costs(scene, camera, config, key, pixel_ids, sample_offset=0, n_samples=PROBE_SPP):
    """The cost probe of a pixel block: (radiance SUM [P, 3], bounce
    iterations [P], the cost ``deal_pixels`` orders by) over ``n_samples``
    samples from ``sample_offset`` through the persistent route."""
    return _render_block_pallas(scene, camera, config, key, pixel_ids, sample_offset,
                                n_samples, return_counts=True)


def deal_pixels(counts, nt: int):
    """Deal the pixels to ``nt`` tiles by cost: [nt, P / nt] pixel ids,
    row t tile t's, costliest first.

    ``counts[i]``: pixel i's cost (a probe's bounce iterations; >= 0).
    Position q of the cost ranking (``argsort(-counts)``, stable: integer
    counts tie constantly, and every rank must deal the same) goes to tile
    ``q % nt`` in even rounds ``q // nt`` and to ``nt - 1 - q % nt`` in odd
    ones (snake order), so the tiles' summed costs differ by at most one
    pixel's.  ``P % nt`` must be 0; one tile takes them in cost order."""
    order = torch.argsort(-counts, stable=True).reshape(-1, nt)
    order[1::2] = order[1::2].flip(1)
    return order.t()


def balanced_pixel_perm(scene, camera, config, key, probe_spp=PROBE_SPP):
    """Cost-balanced pixel order for the gradient routes (``fit(balance=
    True)``): the pixels costliest first by a ``probe_costs`` of
    ``probe_spp`` spp, run under ``torch.no_grad()``."""
    pixel_ids = torch.arange(config.num_pixels, device=scene.device)
    with torch.no_grad():
        _, counts = probe_costs(scene, camera, config, key, pixel_ids, 0, probe_spp)
    return deal_pixels(counts, 1)[0]


def _requires_grad(scene, camera=None) -> bool:
    """Whether a scene leaf (or, given a camera, a camera leaf) needs a
    gradient."""
    leaves = [scene.centers, scene.radii, scene.albedo, scene.fuzz, scene.ior,
              scene.sky_lo, scene.sky_hi, scene.plane, scene.emission]
    if camera is not None:
        leaves += [camera.origin, camera.lookat, camera.vup, camera.vfov_deg,
                   camera.aperture, camera.focus_dist]
    return any(t is not None and t.requires_grad for t in leaves)


def render_pixel_block(scene, camera, config, key, pixel_ids, sample_offset, n_samples):
    """Radiance SUM [len(pixel_ids), 3] over ``n_samples`` consecutive sample
    ids for an explicit block of pixels, on ``routes.pick``'s route.
    Outside the persistent kernel, samples are folded in ``spp_chunk``-sized
    steps to bound live memory; under autograd each step is recomputed in
    the backward (``torch.utils.checkpoint``), or the streamed regen route
    takes its chunks itself.  The camera's leaves count as differentiated
    too, except on the routes that detach the camera.
    The JAX package's ``_coherent_pixel_order`` (pixel tiles for the TPU
    kernels' block skipping) is not ported: it changes no value, and a
    warp's 32 row-adjacent rays are coherent already."""
    p = pixel_ids.shape[0]
    grad = torch.is_grad_enabled()
    route = routes.pick(scene, config, pixels=p, samples=n_samples,
                        differentiates=grad and _requires_grad(scene))
    if route.name == routes.PERSISTENT:
        # Samples loop inside the kernel: no spp chunking.
        return _render_block_pallas(scene, camera, config, key, pixel_ids, sample_offset, n_samples)
    chunk = routes.spp_chunk(config, n_samples)
    n_steps = n_samples // chunk
    banks = config.grad_regen_banks or None
    if route.name == routes.REGEN_STREAM:
        return render_block_grad_regen_stream(
            scene, camera, config, key, pixel_ids, sample_offset,
            n_samples, chunk, n_banks=banks, checkpoint_idx=not route.keep_words,
        )

    def step(off):
        if route.name == routes.REGEN:
            # One recording forward per chunk; its planes serve the backward.
            return render_block_grad_regen(
                scene, camera, config, key, pixel_ids, off, chunk, n_banks=banks
            )
        pids = pixel_ids.repeat(chunk)
        sids = (off + torch.arange(chunk, device=pixel_ids.device)).repeat_interleave(p)
        rad = render_pixels(scene, camera, config, key, pids, sids)
        return torch.sum(rad.reshape(chunk, p, 3), dim=0)

    remat = n_steps > 1 and grad and _requires_grad(
        scene, None if route.camera_detached else camera)
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
    uninterrupted one.  On the persistent route, ``balance_probe_spp``
    (fewer than ``n_samples``) makes the first samples a cost probe
    (``probe_costs``) and renders the rest with the pixels in cost order
    (``deal_pixels`` with one tile): the unbalanced two-chunk schedule's
    values bit for bit, since lane placement changes no sample."""
    persistent = routes.pick(scene, config, samples=n_samples).name == routes.PERSISTENT
    probe = config.balance_probe_spp if persistent and n_samples > config.balance_probe_spp else 0
    chunk = routes.spp_chunk(config, n_samples)
    h, w = config.height, config.width
    accum = state.accum
    with tracing.span("spt.accumulate", spp=n_samples):
        if probe:
            with tracing.span("spt.accumulate.chunk", spp=probe):
                pixel_ids = torch.arange(config.num_pixels, device=scene.device)
                batch, counts = probe_costs(scene, camera, config, state.next_key, pixel_ids,
                                            state.sample_count, probe)
                accum = accum + batch.reshape(h, w, 3)
            with tracing.span("spt.accumulate.chunk", spp=n_samples - probe):
                perm = deal_pixels(counts, 1)[0]
                rad = _render_block_pallas(scene, camera, config, state.next_key, perm,
                                           state.sample_count + probe, n_samples - probe)
                accum = accum + rad[torch.argsort(perm)].reshape(h, w, 3)
        else:
            for i in range(n_samples // chunk):
                off = state.sample_count + i * chunk
                with tracing.span("spt.accumulate.chunk", spp=chunk):
                    batch = render_sample_batch(scene, camera, config, state.next_key, off, chunk)
                    accum = accum + batch.reshape(h, w, 3)
    return RenderState(
        accum=accum,
        sample_count=state.sample_count + n_samples,
        next_key=state.next_key,
    )


def render(scene: Scene, camera: Camera, config: RenderConfig, key) -> torch.Tensor:
    """One-shot render on the scene's device: [H, W, 3] gamma-corrected
    float image in [0, 1].  What its route carries is in ``routes.CAPS``:
    the persistent route (``use_pallas``) renders soft silhouettes hard, as
    the JAX package's persistent kernel does; it, the regeneration routes and
    the plain route add emission."""
    with tracing.span("spt.render", emitters=scene.emitters()):
        state = init_state(config, key, device=scene.device)
        state = accumulate(state, scene, camera, config, config.spp)
        return state.image(config.gamma)
