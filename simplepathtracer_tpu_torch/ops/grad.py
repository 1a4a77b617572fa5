"""Per-bounce fused gradient kernels: host side, wrappers, plain versions and
the differentiable trace built on them.

Counterpart of the fused half of the JAX package's ``ops/pallas_grad.py``
(``trace_rays_fused``, ``trace_pixels_fused``, ``raygen_tiles`` and the
custom VJP ``_fused_trace``), soft silhouettes included, sphere scenes only
(``render.trace_rays`` sends plane scenes to the eager bounce, as the JAX
package does).  A batch of N explicit rays advances one bounce per launch;
the rays' state is SoA planes [10, N] (origin, direction, throughput,
alive) and their radiance [3, N].

Kernels (``csrc/grad.cu``) and their plain versions, each wrapper taking
its plain version for a CPU tensor only:

* ``grad_forward`` / ``grad_fwd_reference`` -- one bounce: the next state,
  the sky radiance of live misses added to the radiance in place, and the
  residuals its backward reads beside the entry state: the winner index
  (-1 on a dead or missed ray) and, under soft silhouettes, the blocker
  index and the chain's previous winner (the next scan's hard gate).
* ``grad_backward`` / ``grad_bwd_reference`` -- that bounce's adjoint
  (``ops/bounce.py:bounce_tile_adjoint``): the carried (o, d, tp)
  cotangents before the bounce, the winner's 9 attribute cotangents (soft:
  and the blocker's cx cy cz r) and the sky's 6, summed over the batch.
  The attributes are read back from the table by index, where the JAX
  kernel stores all 9 per ray.
* ``raygen`` / ``raygen_reference`` -- thin-lens camera rays for (pixel,
  sample) ids (slots 124/125), detached: the camera is not a leaf there.

``_FusedTrace`` runs the forward ``max_depth`` times and its backward walks
the bounces in reverse, bucketing the attribute cotangents into the table
by winner (and blocker) index with ``ops/bucket.py``.  Its backward returns
the rays' own (origin, direction) cotangents, which autograd chains into
the camera through ``camera.generate_rays`` (``camera_grad``).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple

import torch

from . import bucket as _bucket
from .bounce import bounce_tile, bounce_tile_adjoint
from .cuda_build import MAX_RAYS, load_library, on_cpu, stream
from .grad_regen import (
    _SMEM_SOFT_PER_SPHERE,
    _blocker,
    _bounce_uniforms,
    _crossing_uniforms,
    _scan_soft,
    _scan_winner,
    _winner,
    fresnel_on,
    scene_block,
    scene_inputs,
)
from .persistent import _MAX_SMEM, _SMEM_PER_SPHERE, _f32, camera_constants, camera_ray_plain

# State planes per ray: origin 0:3, direction 3:6, throughput 6:9, alive 9.
STATE_PLANES = 10
# Shared memory of the backward's live-ray rings besides the table
# (csrc/grad.cu kRingBytes: 4 warps x 26 fields x 64 entries x 4 B).
_BWD_RING_BYTES = 4 * 26 * 64 * 4
# Carried cotangent planes: origin, direction, throughput.
CARRY_PLANES = 9
_VARIANTS = {"hard": 0, "soft": 1}


class FusedCall(NamedTuple):
    """What a fused kernel launch reads besides the rays: the [S_pad, 10]
    sphere table, the f32[10] constants (sky 0:6, soft constants 6:10; see
    ``grad_regen.scene_block``), the soft scan's [S_pad, 4] table (soft
    only), the key words and the static options.  ``use_plane`` is always
    False (the route is sphere-only); the plain scan helpers of
    ``ops/grad_regen.py`` read it."""

    tab: torch.Tensor
    consts: torch.Tensor
    soft_tab: torch.Tensor | None
    k0: int
    k1: int
    n_spheres: int
    max_depth: int
    t_min: float
    t_max: float
    rr_start_depth: int
    softness: float
    use_plane: bool = False


def fused_call(tables, sky6, k0, k1, *, max_depth, t_min=1e-3, t_max=3.0e7,
               rr_start_depth=0, softness=0.0) -> FusedCall:
    """A ``FusedCall`` from the 11 sphere tables, sky f32[6] and the key
    words (values only).  Under soft silhouettes the constants carry
    ``intersect.SIL_FRESNEL`` as ``grad_regen.scene_block`` reads it."""
    tab, sky, soft4, soft_tab = scene_block(tables, sky6, softness)
    return FusedCall(
        tab=tab, consts=torch.cat([sky, soft4]).contiguous(), soft_tab=soft_tab,
        k0=int(k0), k1=int(k1), n_spheres=tables[0].shape[0],
        max_depth=int(max_depth), t_min=float(t_min), t_max=float(t_max),
        rr_start_depth=int(rr_start_depth), softness=float(softness),
    )


def variant(call: FusedCall) -> str:
    """The kernel instantiation a call launches: ``hard`` or ``soft``."""
    return "soft" if call.softness > 0.0 else "hard"


# --------------------------------------------------------------------------
# Wrappers


def _check_cuda(call: FusedCall, n: int, *tensors):
    dev = tensors[0].device
    extra = () if call.soft_tab is None else (call.soft_tab,)
    for t in (call.tab, call.consts, *extra, *tensors):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"all inputs must lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"inputs must be float32 or int32, got {t.dtype}")
    if not 0 < n < MAX_RAYS:
        raise ValueError(f"ray count {n} out of range")
    s_pad = call.tab.shape[0]
    per_sphere = _SMEM_PER_SPHERE + (_SMEM_SOFT_PER_SPHERE if call.softness > 0.0 else 0)
    if s_pad == 0 or s_pad * per_sphere > _MAX_SMEM or call.tab.shape[1] != 10:
        raise ValueError(f"a [{s_pad}, 10] table does not fit a block's shared memory")
    if call.consts.shape != (10,):
        raise ValueError("consts must be f32[10]")
    if (call.softness > 0.0) != (call.soft_tab is not None):
        raise ValueError("soft_tab must be given exactly when softness > 0")


def _ptr(t):
    return None if t is None else t.data_ptr()


def grad_forward(call: FusedCall, state, rad, prev, pix, samp, bounce: int):
    """One forward bounce over N rays: ``state`` [10, N] f32, ``rad`` [3, N]
    f32 (this bounce's radiance is added to it in place), ``prev`` [N]
    int32 (soft: the chain's previous winner, -1 for none; else None),
    ``pix`` / ``samp`` [N] int32 pixel and sample ids.  Returns (next state
    [10, N], next previous winner (soft; else None), winner index [N] int32,
    blocker index [N] int32 (soft; else None))."""
    if on_cpu(state):
        return grad_fwd_reference(call, state, rad, prev, pix, samp, bounce)
    soft = call.softness > 0.0
    n = state.shape[1]
    _check_cuda(call, n, state, rad, pix, samp, prev)
    if state.shape != (STATE_PLANES, n) or rad.shape != (3, n) or (
        pix.shape != (n,) or samp.shape != (n,) or soft != (prev is not None)
    ):
        raise ValueError("state [10, N], rad [3, N], pix and samp [N], prev [N] "
                         "exactly when soft")
    dev = state.device
    i32 = torch.int32
    nxt = torch.empty_like(state)
    idx = torch.empty(n, dtype=i32, device=dev)
    bidx = torch.empty(n, dtype=i32, device=dev) if soft else None
    prev_out = torch.empty(n, dtype=i32, device=dev) if soft else None
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_grad_forward(
            n, call.tab.data_ptr(), call.tab.shape[0], call.consts.data_ptr(),
            _VARIANTS[variant(call)], _ptr(call.soft_tab), call.k0, call.k1,
            int(bounce), call.t_min, call.t_max, call.rr_start_depth,
            state.data_ptr(), pix.data_ptr(), samp.data_ptr(), _ptr(prev),
            nxt.data_ptr(), rad.data_ptr(), _ptr(prev_out), idx.data_ptr(),
            _ptr(bidx), stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"fused forward kernel launch failed: CUDA error {err}")
    grad_forward.launches[variant(call)] += 1
    return nxt, prev_out, idx, bidx


# Launches of the kernel, by variant.
grad_forward.launches = Counter()


def grad_backward(call: FusedCall, state, idx, bidx, pix, samp, bounce: int,
                  ct_carry, ct_rad, want_attr: bool = True):
    """The adjoint of bounce ``bounce`` over N rays from its entry ``state``
    [10, N] and the indices its forward recorded (``bidx`` soft only),
    with the carried cotangents ``ct_carry`` [9, N] (of the next state's
    o, d, tp) and the radiance cotangent ``ct_rad`` [3, N].  Returns (the
    carried cotangents of the entry state [9, N], the attribute cotangents
    [9, N] -- soft [13, N], the blocker's cx cy cz r appended; zero where
    no winner (blocker) -- or None unless ``want_attr``, the sky's f32[6]
    summed over the rays)."""
    if on_cpu(state):
        return grad_bwd_reference(call, state, idx, bidx, pix, samp, bounce,
                                  ct_carry, ct_rad, want_attr)
    soft = call.softness > 0.0
    n = state.shape[1]
    _check_cuda(call, n, state, idx, bidx, pix, samp, ct_carry, ct_rad)
    if state.shape != (STATE_PLANES, n) or ct_carry.shape != (CARRY_PLANES, n) or (
        ct_rad.shape != (3, n) or idx.shape != (n,) or soft != (bidx is not None)
    ):
        raise ValueError("state [10, N], ct_carry [9, N], ct_rad [3, N], idx [N], "
                         "bidx [N] exactly when soft")
    if call.tab.shape[0] * _SMEM_PER_SPHERE + _BWD_RING_BYTES > _MAX_SMEM:
        raise ValueError(f"a [{call.tab.shape[0]}, 10] table and the backward's rings do "
                         "not fit a block's shared memory")
    dev = state.device
    f32 = torch.float32
    ct_out = torch.empty_like(ct_carry)
    attr = torch.empty((13 if soft else 9, n), dtype=f32, device=dev) if want_attr else None
    sky = torch.zeros(6, dtype=f32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_grad_backward(
            n, call.tab.data_ptr(), call.tab.shape[0], call.consts.data_ptr(),
            _VARIANTS[variant(call)], call.k0, call.k1, int(bounce), call.t_min,
            call.t_max, call.rr_start_depth, state.data_ptr(), idx.data_ptr(),
            _ptr(bidx), pix.data_ptr(), samp.data_ptr(), ct_carry.data_ptr(),
            ct_rad.data_ptr(), ct_out.data_ptr(), _ptr(attr), sky.data_ptr(),
            stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"fused backward kernel launch failed: CUDA error {err}")
    grad_backward.launches[variant(call)] += 1
    return ct_out, attr, sky


grad_backward.launches = Counter()


def raygen(camera, keys, config):
    """Camera rays [6, N] (origin xyz, unit direction xyz) for the rays'
    (pixel, sample) ids (``keys``: ``ops/sampling.RayCtx``): the JAX
    package's ``raygen_tiles``.  Detached: the camera is not differentiated
    on this route."""
    cam19 = camera_constants(camera, config.width, config.height).detach().contiguous()
    if on_cpu(cam19):
        return raygen_reference(camera, keys, config)
    return _raygen_launch(cam19, keys, config.width, config.height)


def _raygen_launch(cam19, keys, width: int, height: int):
    """The raygen kernel on a camera block ``cam19`` (f32[19] on the card,
    ``persistent.camera_constants``): ``raygen`` without the host's
    camera arithmetic."""
    n = keys.pixel.shape[0]
    pix = keys.pixel.to(torch.int32).contiguous()
    samp = keys.sample.to(torch.int32).contiguous()
    dev = cam19.device
    if not 0 < n < MAX_RAYS or pix.device != dev or samp.device != dev or (
        cam19.shape != (19,) or cam19.dtype != torch.float32 or not cam19.is_contiguous()
    ):
        raise ValueError(f"{n} rays, ids not on {dev}, or cam19 not a contiguous f32[19]")
    rays = torch.empty((6, n), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_raygen(
            n, cam19.data_ptr(), keys.k0, keys.k1, pix.data_ptr(), samp.data_ptr(),
            int(width), _f32(1.0 / width), _f32(1.0 / height), rays.data_ptr(), stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"raygen kernel launch failed: CUDA error {err}")
    raygen.launches["raygen"] += 1
    return rays


# Launches of the kernel (counted in _raygen_launch).
raygen.launches = Counter()


# --------------------------------------------------------------------------
# Plain versions


def _bounce_inputs(call, state, pix, samp, bounce):
    """(o3, d3, tp3, alive, bounce uniforms) of one bounce's entry state."""
    o = tuple(state[c] for c in range(3))
    d = tuple(state[3 + c] for c in range(3))
    tp = tuple(state[6 + c] for c in range(3))
    u = _bounce_uniforms(call, pix.to(torch.int64), samp.to(torch.int64), bounce)
    return o, d, tp, state[9] > 0.0, u


def _bounce_kwargs(call, bidx):
    """Soft silhouettes: the blocker of ``bounce_tile`` from its index."""
    if call.softness <= 0.0:
        return {}
    b = bidx.to(torch.int64)
    return dict(softness=call.softness, blocker=(b >= 0, *_blocker(call, b)),
                fresnel=fresnel_on(call))


def grad_fwd_reference(call: FusedCall, state, rad, prev, pix, samp, bounce: int):
    """Plain version of ``grad_forward`` (same outputs; ``rad`` in place):
    the scan of ``ops/grad_regen.py`` and ``ops/bounce.py:bounce_tile``."""
    grad_fwd_reference.calls += 1
    o, d, tp, alive, u = _bounce_inputs(call, state, pix, samp, bounce)
    bidx = None
    if call.softness > 0.0:
        p64, s64 = pix.to(torch.int64), samp.to(torch.int64)
        ux, uv = _crossing_uniforms(call, p64, s64, bounce)
        idx, bidx = _scan_soft(call, o, d, u[7], ux, uv, prev.to(torch.int64))
        bidx = torch.where(alive, bidx, -1)
    else:
        idx = _scan_winner(call, o, d)
    idx = torch.where(alive, idx, -1)
    a9, mat = _winner(call, idx)
    hit = idx >= 0
    sky6 = tuple(call.consts[i] for i in range(6))
    no, nd, nt, rad3, surv = bounce_tile(
        o, d, tp, a9, mat, hit, alive, u, sky6, bounce >= call.rr_start_depth,
        t_min=call.t_min, t_max=call.t_max, rr_on=bool(call.rr_start_depth),
        **_bounce_kwargs(call, bidx),
    )
    rad += torch.stack(rad3)
    nxt = torch.stack([*no, *nd, *nt, surv])
    i32 = torch.int32
    if bidx is None:
        return nxt, None, idx.to(i32), None
    return nxt, torch.where(hit, idx, -1).to(i32), idx.to(i32), bidx.to(i32)


grad_fwd_reference.calls = 0


def grad_bwd_reference(call: FusedCall, state, idx, bidx, pix, samp, bounce: int,
                       ct_carry, ct_rad, want_attr: bool = True):
    """Plain version of ``grad_backward``: ``bounce_tile_adjoint`` with the
    winner's attributes read from the table by index."""
    grad_bwd_reference.calls += 1
    o, d, tp, alive, u = _bounce_inputs(call, state, pix, samp, bounce)
    idx = idx.to(torch.int64)
    a9, mat = _winner(call, idx)
    hit = idx >= 0
    sky6 = tuple(call.consts[i] for i in range(6))
    ct = tuple(ct_carry[c] for c in range(CARRY_PLANES))
    g = bounce_tile_adjoint(
        o, d, tp, a9, mat, hit, alive, u, sky6, bounce >= call.rr_start_depth,
        ct[0:3], ct[3:6], ct[6:9], tuple(ct_rad[c] for c in range(3)),
        t_min=call.t_min, t_max=call.t_max, rr_on=bool(call.rr_start_depth),
        **_bounce_kwargs(call, bidx),
    )
    carry = torch.stack([*g.o, *g.d, *g.tp])
    attr = None
    if want_attr:
        zero = torch.zeros_like(g.a9[0])
        rows = [torch.where(hit, x, zero) for x in g.a9]
        if call.softness > 0.0:
            bval = bidx >= 0
            rows += [torch.where(bval, x, zero) for x in g.blk4]
        attr = torch.stack(rows)
    return carry, attr, torch.stack(g.sky).sum(dim=1)


grad_bwd_reference.calls = 0


def raygen_reference(camera, keys, config):
    """Plain version of ``raygen``: ``persistent.camera_ray_plain`` as
    [6, N].  The ids are cast to int64, which ``camera_ray_plain`` takes
    (its ``sid << 8`` and threefry words hold u32 values), since
    ``trace_pixels_fused`` passes int32 ids."""
    raygen_reference.calls += 1
    cam19 = camera_constants(camera, config.width, config.height).detach()
    return torch.stack(camera_ray_plain(cam19, keys.k0, keys.k1, keys.pixel.long(),
                                        keys.sample.long(), config.width, config.height))


raygen_reference.calls = 0


# --------------------------------------------------------------------------
# The differentiable trace


@dataclasses.dataclass(frozen=True)
class _Spec:
    """The non-differentiable arguments of one trace."""

    pix: torch.Tensor   # [N] int32
    samp: torch.Tensor  # [N] int32
    k0: int
    k1: int
    max_depth: int
    t_min: float
    t_max: float
    rr_start_depth: int
    softness: float

    def call(self, tables, sky6) -> FusedCall:
        return fused_call(
            tables, sky6, self.k0, self.k1, max_depth=self.max_depth, t_min=self.t_min,
            t_max=self.t_max, rr_start_depth=self.rr_start_depth, softness=self.softness,
        )


class _FusedTrace(torch.autograd.Function):
    """``max_depth`` forward bounces; the backward walks them in reverse.
    Each bounce's entry state and recorded indices are kept only when an
    input needs a gradient; the buckets run only when a table does."""

    @staticmethod
    def forward(ctx, spec, origins, dirs, *inputs):
        call = spec.call(inputs[:11], inputs[11])
        soft = call.softness > 0.0
        n = origins.shape[0]
        f32 = torch.float32
        dev = origins.device
        state = torch.empty((STATE_PLANES, n), dtype=f32, device=dev)
        state[0:3] = origins.detach().t()
        state[3:6] = dirs.detach().t()
        state[6:10] = 1.0
        rad = torch.zeros((3, n), dtype=f32, device=dev)
        prev = torch.full((n,), -1, dtype=torch.int32, device=dev) if soft else None
        keep = any(ctx.needs_input_grad)
        saved = []
        for b in range(call.max_depth):
            nxt, prev, idx, bidx = grad_forward(call, state, rad, prev, spec.pix, spec.samp, b)
            if keep:
                saved += [state, idx] + ([bidx] if soft else [])
            state = nxt
        if keep:
            ctx.save_for_backward(*saved)
        ctx.call, ctx.spec = call, spec
        return rad.t().contiguous()

    @staticmethod
    def backward(ctx, g_rad):
        call, spec = ctx.call, ctx.spec
        soft = call.softness > 0.0
        saved = ctx.saved_tensors
        per = 3 if soft else 2
        n = spec.pix.shape[0]
        dev = spec.pix.device
        f32 = torch.float32
        ct_rad = g_rad.to(f32).t().contiguous()
        carry = torch.zeros((CARRY_PLANES, n), dtype=f32, device=dev)
        # Inputs: spec, origins, dirs, the 11 tables (3:14), sky6.
        want_tab = any(ctx.needs_input_grad[3:14])
        s = call.n_spheres
        d_tab = torch.zeros((s, 9), dtype=f32, device=dev)
        d_sky = torch.zeros(6, dtype=f32, device=dev)
        for b in range(call.max_depth - 1, -1, -1):
            state, idx = saved[per * b], saved[per * b + 1]
            bidx = saved[per * b + 2] if soft else None
            carry, attr, sky = grad_backward(call, state, idx, bidx, spec.pix, spec.samp, b,
                                             carry, ct_rad, want_attr=want_tab)
            d_sky = d_sky + sky
            if want_tab:
                d_tab = d_tab + _bucket.bucket_cols(attr[:9], idx, s)
                if soft:
                    d_blk = _bucket.bucket_cols(attr[9:], bidx, s)
                    d_tab = d_tab + torch.cat([d_blk, d_blk.new_zeros((s, 5))], dim=1)
        tab = (d_tab[:, 0], d_tab[:, 1], d_tab[:, 2], d_tab[:, 3], None,
               d_tab[:, 4], d_tab[:, 5], d_tab[:, 6], None, d_tab[:, 7], d_tab[:, 8])
        return (None, carry[0:3].t(), carry[3:6].t(), *tab, d_sky)


def trace_rays_fused(origins, dirs, keys, scene, config):
    """Differentiable radiance [N, 3] of explicit rays (``origins``,
    ``dirs`` [N, 3]; ``keys`` their ``RayCtx``) through the fused kernels:
    the JAX package's ``trace_rays_fused``.  Gradients reach the sphere
    tables, the sky and the rays themselves."""
    if scene.plane is not None:
        raise ValueError("the fused kernels are sphere-only: plane scenes take the "
                         "eager bounce (render.trace_rays)")
    inputs = scene_inputs(scene)
    spec = _Spec(
        pix=keys.pixel.to(torch.int32).contiguous(), samp=keys.sample.to(torch.int32).contiguous(),
        k0=keys.k0, k1=keys.k1, max_depth=int(config.max_depth), t_min=float(config.t_min),
        t_max=float(config.t_max), rr_start_depth=int(config.rr_start_depth),
        softness=float(config.silhouette_softness),
    )
    return _FusedTrace.apply(spec, origins, dirs, *inputs[:12])


def trace_pixels_fused(camera, keys, scene, config):
    """``trace_rays_fused`` with the camera rays made by the raygen kernel
    (the JAX package's ``trace_pixels_fused``); the camera is detached.
    The ids are cast to int32 once, for raygen and the bounces."""
    keys = keys._replace(pixel=keys.pixel.to(torch.int32).contiguous(),
                         sample=keys.sample.to(torch.int32).contiguous())
    rays = raygen(camera, keys, config)
    return trace_rays_fused(rays[0:3].t(), rays[3:6].t(), keys, scene, config)
