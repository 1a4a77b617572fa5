"""The explicit-ray forward bounce kernel: host side, wrapper and plain
version.

Counterpart of the JAX package's ``ops/pallas_bounce.py``
(``bounce_step_pallas``, kernel ``_bounce_kernel``; named ``bounce_step``
here: ``ops/bounce.py`` holds the gradient kernels' ``bounce_tile``).  It
serves ``render.trace_rays_pallas``, the ``bounce_step`` route of
``trace_rays`` and ``render_pixels`` (``routes.py``): a batch of N explicit
rays advances one bounce per launch on SoA state planes [13, N] (origin
0:3, direction 3:6, throughput 6:9, radiance 9:12, alive 12), their pixel
and sample ids [N] int32 beside.  Forward only.

On a CUDA tensor ``bounce_step`` launches the kernel in
``csrc/bounce_step.cu``; on a CPU tensor it calls the plain version
``bounce_step_reference``.  Both follow the TPU kernel's arithmetic, which
is not the persistent kernel's: the origin, direction and alive updates are
lerps by 0/1 masks, the direction updates with the survival mask from
before Russian roulette, RR multiplies by 1 / q, the sky is added on a live
miss before the scatter.  A dead ray keeps its state (alive 0); the JAX
kernel's output for dead rays depends on their 1024-ray block and is not
part of the contract.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..types import Material
from .closest_hit import sphere_attrs_plain, sphere_table
from .cuda_build import MAX_RAYS, load_library, on_cpu, stream
from .persistent import TABLE_SLOT_BYTES, _scatter_plain, check_smem, closest_hit_plain
from .sampling import RayCtx, bounce_noise

# State planes per ray: origin 0:3, direction 3:6, throughput 6:9,
# radiance 9:12, alive 12.
STATE_PLANES = 13
_ALIVE = 12


class BounceCall(NamedTuple):
    """What a launch reads besides the rays: the [S_pad, 10] sphere table,
    the f32[13] constants (sky 0:6, ground plane 6:13, zeros without one),
    the key words and the static options."""

    tab: torch.Tensor
    consts: torch.Tensor
    use_plane: bool
    k0: int
    k1: int
    t_min: float
    t_max: float
    rr_start_depth: int


def bounce_call(tables, sky6, plane7, k0, k1, *, t_min=1e-3, t_max=3.0e7,
                rr_start_depth=0) -> BounceCall:
    """A ``BounceCall`` from the 11 sphere tables, sky f32[6], the plane
    f32[7] or None and the key words (values only)."""
    tab = sphere_table(tables)
    with torch.no_grad():
        plane = plane7 if plane7 is not None else torch.zeros(7, device=tab.device)
        consts = torch.cat([sky6.detach(), plane.detach()]).to(torch.float32).contiguous()
    return BounceCall(
        tab=tab, consts=consts, use_plane=plane7 is not None, k0=int(k0), k1=int(k1),
        t_min=float(t_min), t_max=float(t_max), rr_start_depth=int(rr_start_depth),
    )


def initial_state(origins, dirs) -> torch.Tensor:
    """[13, N] state of fresh rays: throughput 1, radiance 0, alive."""
    n = origins.shape[0]
    state = torch.empty((STATE_PLANES, n), dtype=torch.float32, device=origins.device)
    state[0:3] = origins.detach().T
    state[3:6] = dirs.detach().T
    state[6:9] = 1.0
    state[9:12] = 0.0
    state[_ALIVE] = 1.0
    return state


def bounce_step(call: BounceCall, state, pix, samp, bounce: int):
    """Bounce ``bounce`` over N rays: the next state [13, N] from ``state``
    [13, N] f32 and the pixel and sample ids ``pix``, ``samp`` [N] int32."""
    if on_cpu(state):
        return bounce_step_reference(call, state, pix, samp, bounce)
    n = state.shape[1]
    dev = state.device
    for t in (call.tab, call.consts, state, pix, samp):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"all inputs must be contiguous on {dev}")
    if state.shape != (STATE_PLANES, n) or state.dtype != torch.float32 or (
        pix.shape != (n,) or samp.shape != (n,) or pix.dtype != torch.int32
        or samp.dtype != torch.int32
    ):
        raise ValueError("state must be [13, N] float32, pix and samp [N] int32")
    if not 0 < n < MAX_RAYS:
        raise ValueError(f"ray count {n} out of range")
    s_pad = call.tab.shape[0]
    if call.tab.shape != (s_pad, 10) or call.consts.shape != (13,):
        raise ValueError("the table must be [S_pad, 10] and the constants f32[13]")
    check_smem(s_pad, TABLE_SLOT_BYTES)
    nxt = torch.empty_like(state)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_bounce_step(
            n, call.tab.data_ptr(), s_pad, call.consts.data_ptr(), int(call.use_plane),
            call.k0, call.k1, int(bounce), call.t_min, call.t_max, call.rr_start_depth,
            state.data_ptr(), pix.data_ptr(), samp.data_ptr(), nxt.data_ptr(),
            stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"bounce-step kernel launch failed: CUDA error {err}")
    tracing.count("launch.bounce_step")
    return nxt


def bounce_step_reference(call: BounceCall, state, pix, samp, bounce: int):
    """Plain version of ``bounce_step``: the same next state, in the
    kernel's operations over all N rays at once."""
    tracing.count("plain.bounce_step_reference")
    tab = call.tab
    o = [state[c] for c in range(3)]
    d = [state[3 + c] for c in range(3)]
    tp = [state[6 + c] for c in range(3)]
    rad = [state[9 + c] for c in range(3)]
    alive = state[_ALIVE] > 0.0
    bt, bi, hit = closest_hit_plain(*o, *d, tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 3],
                                    call.t_min, call.t_max)
    attr, mat = sphere_attrs_plain(tab, torch.where(hit, bi, -1))
    w = list(attr)
    if call.use_plane:
        # plane_override: a virtual unit sphere tangent at the hit point.
        pl = call.consts[6:13].tolist()
        denom = d[0] * pl[0] + d[1] * pl[1] + d[2] * pl[2]
        num = -(o[0] * pl[0] + o[1] * pl[1] + o[2] * pl[2] + pl[3])
        live = torch.abs(denom) > 1e-8
        tpl = num / torch.where(live, denom, torch.ones_like(denom))
        wins = live & (tpl > call.t_min) & (tpl < bt)
        sgn = torch.where(denom > 0.0, -1.0, 1.0)
        for c in range(3):
            w[c] = torch.where(wins, (o[c] + tpl * d[c]) - sgn * pl[c], w[c])
            w[4 + c] = torch.where(wins, pl[4 + c], w[4 + c])
        w[3] = torch.where(wins, 1.0, w[3])
        w[7] = torch.where(wins, 0.0, w[7])
        w[8] = torch.where(wins, 1.0, w[8])
        mat = torch.where(wins, int(Material.LAMBERTIAN), mat)
        bt = torch.where(wins, tpl, bt)
        hit = hit | wins
    p = [o[c] + bt * d[c] for c in range(3)]
    nrm = [(p[c] - w[c]) / w[3] for c in range(3)]
    inv = torch.rsqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2] + 1e-20)
    nrm = [x * inv for x in nrm]
    u = bounce_noise(RayCtx(call.k0, call.k1, pix.to(torch.int64), samp.to(torch.int64)),
                     bounce).unbind(1)
    sky = call.consts[0:6].tolist()
    s01 = 0.5 * (d[1] + 1.0)
    mf = torch.where(hit, 0.0, 1.0)
    rad = [rad[c] + tp[c] * (sky[c] + (sky[3 + c] - sky[c]) * s01) * mf for c in range(3)]
    sd, is_diel, scattered = _scatter_plain(*d, *nrm, mat, w[7], w[8], u)
    surv = hit & scattered
    lf = torch.where(hit, 1.0, 0.0)
    sf = torch.where(surv, 1.0, 0.0)
    nt = [tp[c] * torch.where(surv & ~is_diel, w[4 + c], 1.0) for c in range(3)]
    no = [o[c] + (p[c] - o[c]) * lf for c in range(3)]
    nd = [d[c] + (sd[c] - d[c]) * sf for c in range(3)]
    if call.rr_start_depth > 0 and bounce >= call.rr_start_depth:
        q = torch.clamp(torch.maximum(torch.maximum(nt[0], nt[1]), nt[2]), 0.05, 1.0)
        surv = surv & ~(u[6] >= q)
        boost = torch.where(surv, 1.0 / q, 1.0)
        nt = [x * boost for x in nt]
    new = torch.stack([*no, *nd, *nt, *rad, surv.to(torch.float32)])
    # A dead ray keeps its state, alive 0.
    out = torch.where(alive[None, :], new, state)
    out[_ALIVE] = (alive & surv).to(torch.float32)
    return out
