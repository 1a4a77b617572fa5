"""Regeneration gradient kernels: host side, wrappers, plain versions and the
differentiable traces built on them.

Counterpart of the JAX package's ``ops/pallas_grad_regen.py`` (hard
configurations: no soft silhouette).  A lane of the banked layout
(``persistent.bank_geometry``) runs its pixels' sample chains back to back:
when a path ends, the next iteration regenerates the next sample's camera
ray.  Iteration ``it`` of a lane is one bounce; the static budget
``n_iter`` (banks x samples x depth, rounded up to a multiple of 9) is the
worst case, so every chain completes.

Kernels (``csrc/grad_regen.cu``, ``csrc/bucket.cu``) and their plain
versions, each wrapper taking its plain version for a CPU tensor only:

* ``regen_forward`` / ``regen_fwd_reference`` -- the recording forward:
  per-position radiance sums (ascending sample order), per-lane live
  iteration counts, and either the 25 residual planes (``emit_full``) or
  only the winner indices packed three to an int32 word.
* ``regen_refwd`` / ``regen_refwd_reference`` -- the scan-free re-forward:
  the same state evolution with the sphere scan replaced by the recorded
  index; it emits the planes the ``emit_full`` forward would have.
* ``regen_backward`` / ``regen_bwd_reference`` -- the reverse walk: the
  9 winner-attribute cotangents per iteration and per-lane sky (6) and
  plane (4) partial sums, through ``ops/bounce.py:bounce_tile_adjoint``.
* ``bucket.bucket_cols`` -- the attribute cotangents summed per sphere.

Three ``torch.autograd.Function``s use them, as the JAX package's custom
VJPs do: ``_RegenTrace`` (one recording forward per spp chunk, planes kept
for its backward), ``_RegenTraceStream`` (idx-only forward over every
chunk, then per chunk a re-forward + backward) and ``_RegenTraceCkstream``
(the same, but the backward re-records each chunk's indices instead of
holding them all).

Residual planes are stored [plane, n_iter, n_lanes]: the 20 float planes
in ``resf`` and the 5 integer planes in ``resi`` (``RESIDUAL_PLANES`` gives
the JAX order of all 25; ``residual_planes`` reassembles it).  Iterations
after a lane's end read as dead: ``alive`` 0, ``idx`` -1, packed words 0;
the other planes are not written there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import bucket as _bucket
from .bounce import bounce_tile, bounce_tile_adjoint
from .cuda_build import load_library
from .persistent import (
    _MAX_SMEM,
    _SMEM_PER_SPHERE,
    GPU_BANKS,
    _f32,
    bank_geometry,
    camera_constants,
    camera_ray_plain,
    closest_hit_plain,
    pad_scene_tables,
)
from .sampling import _to_unit_float, key_words, threefry2x32

# Iterations are budgeted in multiples of this (the TPU kernel's chunk of
# the sequential grid; kept so the plane shapes match the JAX package's).
CHUNK = 9
# Winner indices are packed 3 per int32 word, 10 bits of idx + 1 each
# (0 = miss or dead): the JAX package's layout, word for word.
IDX_PACK = 3
IDX_BITS = 10
IDX_MASK = (1 << IDX_BITS) - 1
# Largest sphere count whose 16-padded table fits the 10-bit code with the
# plane code reserved.
IDX_PACK_MAX_SPHERES = ((IDX_MASK - 1) // 16) * 16
# Winner code of a ground-plane hit: packs into 10 bits and names no sphere.
PLANE_IDX = IDX_MASK - 1

# The 25 residual planes, in the JAX package's order (pallas_grad_regen.py).
RESIDUAL_PLANES = (
    "ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",   # entry ray, tp
    "alive", "regen", "kb", "s", "b",                      # masks, chain ids
    "idx", "mat",                                          # winner discrete
    "cx", "cy", "cz", "r", "ar", "ag", "ab", "fz", "io",    # winner attrs
)
# Which of the 25 each resf (float) / resi (int32) plane holds.
_F_PLANES = tuple(range(11)) + tuple(range(16, 25))
_I_PLANES = tuple(range(11, 16))
_M32 = 0xFFFFFFFF
_MODES = {"full": 0, "idx": 1, "refwd": 2}


def residual_planes(resf, resi):
    """The 25 [n_iter, n_lanes] planes in the JAX package's order."""
    out = [None] * len(RESIDUAL_PLANES)
    for k, j in enumerate(_F_PLANES):
        out[j] = resf[k]
    for k, j in enumerate(_I_PLANES):
        out[j] = resi[k]
    return out


class RegenCall(NamedTuple):
    """What one launch of the regen kernels reads, besides the sample
    offset: pixel ids, the [S_pad, 10] sphere table (cx cy cz r albedo rgb
    fuzz ior material), the f32[32] constants (sky 0:6, plane 6:13, camera
    13:32), the key words and the static shape of the lane layout."""

    pixel_ids: torch.Tensor
    tab: torch.Tensor
    consts: torch.Tensor
    k0: int
    k1: int
    n_spheres: int
    use_plane: bool
    n_samples: int
    max_depth: int
    width: int
    height: int
    t_min: float
    t_max: float
    rr_start_depth: int
    n_banks: int
    n_lanes: int
    n_iter: int


def regen_call(tables, sky6, plane7, cam19, key, pixel_ids, *, n_samples,
               max_depth, width, height, t_min=1e-3, t_max=3.0e7,
               rr_start_depth=0, n_banks=GPU_BANKS) -> RegenCall:
    """A ``RegenCall`` from the 11 sphere tables (cx, cy, cz, radius,
    radius^2, albedo rgb, material, fuzz, ior), sky f32[6], plane f32[7] or
    None, camera f32[19] and key (values only: nothing here is
    differentiated)."""
    f32 = torch.float32
    with torch.no_grad():
        s = tables[0].shape[0]
        cx, cy, cz, rad, _r2, ar, ag, ab, mat, fz, io = pad_scene_tables(
            [t.detach() for t in tables]
        )
        tab = torch.stack(
            [cx, cy, cz, rad, ar, ag, ab, fz, io, mat.to(f32)], dim=1
        ).to(f32).contiguous()
        dev = tab.device
        plane = (plane7.detach() if plane7 is not None
                 else torch.zeros(7, dtype=f32, device=dev))
        consts = torch.cat(
            [sky6.detach().to(f32), plane.to(f32), cam19.detach().to(f32)]
        ).contiguous()
    p = pixel_ids.shape[0]
    nb, n_lanes = bank_geometry(p, n_banks)
    budget = nb * int(n_samples) * int(max_depth)
    k0, k1 = key_words(key)
    return RegenCall(
        pixel_ids=pixel_ids.to(torch.int32).contiguous(), tab=tab,
        consts=consts, k0=k0, k1=k1, n_spheres=s,
        use_plane=plane7 is not None, n_samples=int(n_samples),
        max_depth=int(max_depth), width=int(width), height=int(height),
        t_min=float(t_min), t_max=float(t_max),
        rr_start_depth=int(rr_start_depth), n_banks=nb, n_lanes=n_lanes,
        n_iter=-(-budget // CHUNK) * CHUNK,
    )


# --------------------------------------------------------------------------
# Wrappers


def _device(call: RegenCall) -> torch.device:
    dev = call.pixel_ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_cuda(call: RegenCall, *tensors):
    dev = call.pixel_ids.device
    for t in (call.tab, call.consts, *tensors):
        if t.device != dev:
            raise ValueError(f"all inputs must lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    p, s_pad = call.pixel_ids.shape[0], call.tab.shape[0]
    if p == 0 or p >= 2**31 or call.n_iter * call.n_lanes >= 2**31:
        raise ValueError(f"pixel count {p} or plane size out of range")
    if s_pad == 0 or s_pad * _SMEM_PER_SPHERE > _MAX_SMEM:
        raise ValueError(f"{s_pad} sphere slots do not fit a block's shared memory")
    if s_pad > IDX_PACK_MAX_SPHERES:
        raise ValueError(
            f"{s_pad} sphere slots exceed the {IDX_PACK_MAX_SPHERES} the "
            "10-bit winner code holds"
        )
    if call.consts.shape != (32,) or call.tab.shape[1] != 10:
        raise ValueError("consts must be f32[32] and the table [S, 10]")
    if not 0 < call.max_depth <= 30 or call.n_samples < 1:
        raise ValueError("need 0 < max_depth <= 30 and n_samples >= 1")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_forward(call, sample_offset, mode, idx_in, rad, cnt, resf, resi,
                    packed):
    lib = load_library()
    dev = call.pixel_ids.device
    with torch.cuda.device(dev):
        err = lib.lib.spt_regen_forward(
            call.pixel_ids.data_ptr(), call.pixel_ids.shape[0], call.n_lanes,
            call.n_banks, call.tab.data_ptr(), call.tab.shape[0],
            call.consts.data_ptr(), int(call.use_plane), call.k0, call.k1,
            int(sample_offset) & _M32, call.n_samples, call.max_depth,
            call.width, _f32(1.0 / call.width), _f32(1.0 / call.height),
            call.t_min, call.t_max, call.rr_start_depth, call.n_iter,
            _MODES[mode], _ptr(idx_in), _ptr(rad), _ptr(cnt), _ptr(resf),
            _ptr(resi), _ptr(packed), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"regen {mode} kernel launch failed: CUDA error {err}")


def regen_forward(call: RegenCall, sample_offset, emit_full: bool):
    """Recording forward over ``call.n_samples`` samples from
    ``sample_offset``.  Returns (radiance sums [P, 3], live iterations per
    lane [n_lanes] f32, residuals): ``(resf [20, n_iter, n_lanes] f32,
    resi [5, n_iter, n_lanes] int32)`` with ``emit_full``, else the packed
    winner words [n_iter / 3, n_lanes] int32."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_fwd_reference(call, sample_offset, emit_full)
    _check_cuda(call)
    p, b, n = call.pixel_ids.shape[0], call.n_iter, call.n_lanes
    rad = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.float32, device=dev)
    resf = resi = packed = None
    if emit_full:
        resf = torch.empty((20, b, n), dtype=torch.float32, device=dev)
        resi = torch.empty((5, b, n), dtype=torch.int32, device=dev)
    else:
        packed = torch.empty((b // IDX_PACK, n), dtype=torch.int32, device=dev)
    _launch_forward(call, sample_offset, "full" if emit_full else "idx", None,
                    rad, cnt, resf, resi, packed)
    regen_forward.launches += 1
    return rad, cnt, ((resf, resi) if emit_full else packed)


regen_forward.launches = 0


def regen_refwd(call: RegenCall, sample_offset, packed):
    """Scan-free re-forward from the packed winner words of one chunk:
    ``(resf, resi)`` as ``regen_forward(emit_full=True)`` gives them."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_refwd_reference(call, sample_offset, packed)
    _check_cuda(call, packed)
    b, n = call.n_iter, call.n_lanes
    if packed.shape != (b // IDX_PACK, n) or packed.dtype != torch.int32:
        raise ValueError(f"packed words must be int32 [{b // IDX_PACK}, {n}]")
    resf = torch.empty((20, b, n), dtype=torch.float32, device=dev)
    resi = torch.empty((5, b, n), dtype=torch.int32, device=dev)
    _launch_forward(call, sample_offset, "refwd", packed, None, None, resf,
                    resi, None)
    regen_refwd.launches += 1
    return resf, resi


regen_refwd.launches = 0


def regen_backward(call: RegenCall, sample_offset, resf, resi, ct_rad):
    """Reverse walk over one chunk's residual planes with the radiance
    cotangent ``ct_rad`` [P, 3].  Returns (attribute cotangents
    [9, n_iter, n_lanes] f32, zero where idx < 0; per-lane partials
    [10, n_lanes] f32: sky lo/hi rgb, then plane offset and albedo rgb)."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_bwd_reference(call, sample_offset, resf, resi, ct_rad)
    ct_rad = ct_rad.to(torch.float32).contiguous()
    _check_cuda(call, resf, resi, ct_rad)
    b, n = call.n_iter, call.n_lanes
    if resf.shape != (20, b, n) or resi.shape != (5, b, n) or (
        ct_rad.shape != (call.pixel_ids.shape[0], 3)
    ):
        raise ValueError("residual planes or radiance cotangent mis-shaped")
    ct_planes = torch.empty((9, b, n), dtype=torch.float32, device=dev)
    partials = torch.empty((10, n), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_regen_backward(
            call.pixel_ids.data_ptr(), call.pixel_ids.shape[0], n,
            call.n_banks, call.consts.data_ptr(), int(call.use_plane),
            call.k0, call.k1, int(sample_offset) & _M32, b, call.t_min,
            call.t_max, call.rr_start_depth, resf.data_ptr(), resi.data_ptr(),
            ct_rad.data_ptr(), ct_planes.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"regen backward kernel launch failed: CUDA error {err}")
    regen_backward.launches += 1
    return ct_planes, partials


regen_backward.launches = 0


# --------------------------------------------------------------------------
# Plain versions


def _lane_pixels(call: RegenCall):
    """[n_banks, n_lanes] int64 pixel ids of the lane layout (overflow
    positions repeat the last pixel) and their positions (unclamped)."""
    dev = call.pixel_ids.device
    pos = (torch.arange(call.n_banks, device=dev)[:, None] * call.n_lanes
           + torch.arange(call.n_lanes, device=dev)[None, :])
    p = call.pixel_ids.shape[0]
    return call.pixel_ids.to(torch.int64)[pos.clamp(max=p - 1)], pos


def _bounce_uniforms(call: RegenCall, pix, samp, b):
    """The 8 bounce uniforms of bounce ``b`` (per lane): slots 4b .. 4b+3."""
    c1b = (samp << 8) & _M32
    u = []
    for e in range(4):
        w0, w1 = threefry2x32(call.k0, call.k1, pix, c1b | (b * 4 + e))
        u += [_to_unit_float(w0), _to_unit_float(w1)]
    return tuple(u)


def _winner(call: RegenCall, idx):
    """The winner's 9 attributes and material for indices ``idx`` [N]: a
    sphere slot, the ground plane (PLANE_IDX: normal, offset, albedo; fuzz
    0, ior 1) or a miss (-1: the scan's defaults r = 1, ior = 1)."""
    tab = call.tab
    s_pad = tab.shape[0]
    rows = tab[idx.clamp(0, s_pad - 1)]
    default = tab.new_tensor([0, 0, 0, 1, 0, 0, 0, 0, 1, 0])
    vals = torch.where(((idx >= 0) & (idx < s_pad))[:, None], rows, default)
    if call.use_plane:
        plane_row = torch.cat([call.consts[6:13], tab.new_tensor([0, 1, 0])])
        vals = torch.where((idx == PLANE_IDX)[:, None], plane_row, vals)
    return tuple(vals[:, j] for j in range(9)), vals[:, 9].to(torch.int64)


def _scan_winner(call: RegenCall, o, d):
    """Winner index per ray: closest sphere, then the ground plane where it
    is nearer (PLANE_IDX); -1 on a miss."""
    tab = call.tab
    bt, bi, hit = closest_hit_plain(
        *o, *d, tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 3], call.t_min, call.t_max
    )
    bi = torch.where(hit, bi, -1)
    if call.use_plane:
        pl = call.consts[6:13].tolist()
        denom = d[0] * pl[0] + d[1] * pl[1] + d[2] * pl[2]
        num = -(o[0] * pl[0] + o[1] * pl[1] + o[2] * pl[2] + pl[3])
        live = torch.abs(denom) > 1e-8
        tpl = num / torch.where(live, denom, torch.ones_like(denom))
        wins = live & (tpl > call.t_min) & (tpl < bt)
        bi = torch.where(wins, PLANE_IDX, bi)
    return bi


def _replay(call: RegenCall, sample_offset, mode: str, packed_in=None):
    """The regen kernels' state evolution over all lanes at once.  ``mode``:
    'full' / 'idx' (recording forward; winners from the scan) or 'refwd'
    (winners from ``packed_in``)."""
    dev = call.pixel_ids.device
    f32, i64 = torch.float32, torch.int64
    n, b_total, nb = call.n_lanes, call.n_iter, call.n_banks
    p = call.pixel_ids.shape[0]
    lanes = torch.arange(n, device=dev)
    pixb, _ = _lane_pixels(call)
    sky6 = tuple(call.consts[i] for i in range(6))
    rr_on = bool(call.rr_start_depth)
    zero, one = torch.zeros(n, dtype=f32, device=dev), torch.ones(n, dtype=f32, device=dev)
    kb, s, b = (torch.zeros(n, dtype=i64, device=dev) for _ in range(3))
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    o, d, tp = (zero,) * 3, (zero, zero, one), (one,) * 3
    acc = (zero,) * 3
    cnt = zero
    rad_out = torch.zeros((p, 3), dtype=f32, device=dev)
    planes = mode != "idx"
    if planes:
        resf = torch.empty((20, b_total, n), dtype=f32, device=dev)
        resi = torch.empty((5, b_total, n), dtype=torch.int32, device=dev)
    else:
        packed = torch.zeros((b_total // IDX_PACK, n), dtype=torch.int32, device=dev)
        word = torch.zeros(n, dtype=i64, device=dev)
    soff = int(sample_offset)
    for it in range(b_total):
        regen = ~alive & (kb < nb)
        if not bool((alive | regen).any()):
            # Every lane is done: the remaining iterations are dead.
            if planes:
                resf[9, it:] = 0.0
                resi[3, it:] = -1
            elif it % IDX_PACK:
                packed[it // IDX_PACK] = word.to(torch.int32)
            break
        samp = (soff + s) & _M32
        pix = pixb[kb.clamp(max=nb - 1), lanes]
        if bool(regen.any()):
            ray = camera_ray_plain(call.consts[13:32], call.k0, call.k1, pix, samp,
                                   call.width, call.height)
            o = tuple(torch.where(regen, r, x) for r, x in zip(ray[:3], o))
            d = tuple(torch.where(regen, r, x) for r, x in zip(ray[3:], d))
            tp = tuple(torch.where(regen, one, x) for x in tp)
            b = torch.where(regen, 0, b)
            alive = alive | regen
        cnt = cnt + alive.to(f32)
        if planes:
            for c in range(3):
                resf[c, it], resf[3 + c, it], resf[6 + c, it] = o[c], d[c], tp[c]
            resf[9, it] = alive.to(f32)
            resf[10, it] = regen.to(f32)
            resi[0, it], resi[1, it], resi[2, it] = kb, s, b
        if mode == "refwd":
            w = packed_in[it // IDX_PACK].to(i64)
            idx = ((w >> (IDX_BITS * (it % IDX_PACK))) & IDX_MASK) - 1
        else:
            idx = _scan_winner(call, o, d)
        idx = torch.where(alive, idx, -1)
        a9, mat = _winner(call, idx)
        hit = idx >= 0
        if planes:
            resi[3, it], resi[4, it] = idx, mat
            for j in range(9):
                resf[11 + j, it] = a9[j]
        else:
            field = it % IDX_PACK
            word = idx + 1 if field == 0 else word + (idx + 1) * (1 << (IDX_BITS * field))
            if field == IDX_PACK - 1:
                packed[it // IDX_PACK] = word.to(torch.int32)

        u = _bounce_uniforms(call, pix, samp, b)
        pm = (idx == PLANE_IDX) if call.use_plane else None
        o, d, tp, rad3, surv_f = bounce_tile(
            o, d, tp, a9, mat, hit, alive, u, sky6, b >= call.rr_start_depth,
            t_min=call.t_min, t_max=call.t_max, rr_on=rr_on, plane_mask=pm,
        )
        surv = (surv_f > 0.0) & (b + 1 < call.max_depth)
        acc = tuple(a + r for a, r in zip(acc, rad3))
        terminated = alive & ~surv
        s_next = s + 1
        bank_done = s_next >= call.n_samples
        flush = terminated & bank_done
        if bool(flush.any()):
            pos = kb * n + lanes
            m = flush & (pos < p)
            rad_out[pos[m]] = torch.stack(acc, dim=-1)[m]
            acc = tuple(torch.where(flush, zero, a) for a in acc)
        b = torch.where(surv, b + 1, b)
        s = torch.where(terminated, torch.where(bank_done, 0, s_next), s)
        kb = torch.where(flush, kb + 1, kb)
        alive = surv
    if mode == "refwd":
        return resf, resi
    return rad_out, cnt, ((resf, resi) if planes else packed)


def regen_fwd_reference(call: RegenCall, sample_offset, emit_full: bool):
    """Plain version of ``regen_forward`` (same outputs)."""
    regen_fwd_reference.calls += 1
    return _replay(call, sample_offset, "full" if emit_full else "idx")


regen_fwd_reference.calls = 0


def regen_refwd_reference(call: RegenCall, sample_offset, packed):
    """Plain version of ``regen_refwd``."""
    regen_refwd_reference.calls += 1
    return _replay(call, sample_offset, "refwd", packed)


regen_refwd_reference.calls = 0


def regen_bwd_reference(call: RegenCall, sample_offset, resf, resi, ct_rad):
    """Plain version of ``regen_backward``: the reverse walk over all lanes
    at once through ``bounce_tile_adjoint``."""
    regen_bwd_reference.calls += 1
    dev = call.pixel_ids.device
    f32, i64 = torch.float32, torch.int64
    n, b_total, nb = call.n_lanes, call.n_iter, call.n_banks
    p = call.pixel_ids.shape[0]
    lanes = torch.arange(n, device=dev)
    pixb, pos = _lane_pixels(call)
    ctb = torch.zeros((nb, n, 3), dtype=f32, device=dev)
    valid = pos < p
    ctb[valid] = ct_rad.to(f32)[pos[valid]]
    sky6 = tuple(call.consts[i] for i in range(6))
    rr_on = bool(call.rr_start_depth)
    zero = torch.zeros(n, dtype=f32, device=dev)
    co = cd = ctp = (zero,) * 3
    sky_part, pl_part = (zero,) * 6, (zero,) * 4
    ct_planes = torch.zeros((9, b_total, n), dtype=f32, device=dev)
    soff = int(sample_offset)
    for it in range(b_total - 1, -1, -1):
        alive = resf[9, it] > 0.0
        if not bool(alive.any()):
            continue
        # Dead lanes' planes hold no data: clamp their bank for the gathers.
        kb = resi[0, it].to(i64).clamp(0, nb - 1)
        s, b, idx, mat = (resi[k, it].to(i64) for k in range(1, 5))
        pix = pixb[kb, lanes]
        u = _bounce_uniforms(call, pix, (soff + s) & _M32, b)
        hit = idx >= 0
        pm = (idx == PLANE_IDX) if call.use_plane else None
        ctr = tuple(ctb[kb, lanes, c] for c in range(3))
        g_o, g_d, g_tp, g_a9, g_sky = bounce_tile_adjoint(
            tuple(resf[c, it] for c in range(3)),
            tuple(resf[3 + c, it] for c in range(3)),
            tuple(resf[6 + c, it] for c in range(3)),
            tuple(resf[11 + j, it] for j in range(9)),
            mat, hit, alive, u, sky6, b >= call.rr_start_depth,
            co, cd, ctp, ctr,
            t_min=call.t_min, t_max=call.t_max, rr_on=rr_on, plane_mask=pm,
        )
        for j in range(9):
            ct_planes[j, it] = torch.where(hit, g_a9[j], zero)
        sky_part = tuple(a + g for a, g in zip(sky_part, g_sky))
        if pm is not None:
            pl_part = tuple(a + torch.where(pm, g, zero)
                            for a, g in zip(pl_part, g_a9[3:7]))
        # A chain's camera ray starts here: its carried cotangents restart.
        regen = alive & (resf[10, it] > 0.0)
        co, cd, ctp = (tuple(torch.where(regen, zero, g) for g in gs)
                       for gs in (g_o, g_d, g_tp))
    return ct_planes, torch.stack(sky_part + pl_part)


regen_bwd_reference.calls = 0


# --------------------------------------------------------------------------
# Differentiable traces


@dataclasses.dataclass(frozen=True)
class _Spec:
    """The non-differentiable arguments of one trace."""

    pixel_ids: torch.Tensor
    cam19: torch.Tensor
    key: torch.Tensor
    sample_offset: int
    n_samples: int      # samples of the whole trace
    chunk: int          # samples per launch
    max_depth: int
    width: int
    height: int
    t_min: float
    t_max: float
    rr_start_depth: int
    n_banks: int

    def call(self, tables, sky6, plane7) -> RegenCall:
        return regen_call(
            tables, sky6, plane7, self.cam19, self.key, self.pixel_ids,
            n_samples=self.chunk, max_depth=self.max_depth, width=self.width,
            height=self.height, t_min=self.t_min, t_max=self.t_max,
            rr_start_depth=self.rr_start_depth, n_banks=self.n_banks,
        )

    def offsets(self):
        return [self.sample_offset + c * self.chunk
                for c in range(self.n_samples // self.chunk)]


def _bwd_from_residuals(call, sample_offset, resf, resi, g_rad):
    """Backward kernel + bucket over one chunk's planes: (d_tab [S, 9],
    d_sky6 [6], d_plane4 [4] = offset + albedo rgb)."""
    ct_planes, partials = regen_backward(call, sample_offset, resf, resi, g_rad)
    d_tab = _bucket.bucket_cols(ct_planes, resi[3], call.n_spheres)
    return d_tab, partials[:6].sum(dim=1), partials[6:].sum(dim=1)


def _input_grads(d_tab, d_sky6, d_plane4, has_plane):
    """Cotangents of (spec, 11 tables, sky6, plane7): None for the scan-only
    r^2 and the integer material, zero for the plane's unit normal."""
    tab = (d_tab[:, 0], d_tab[:, 1], d_tab[:, 2], d_tab[:, 3], None,
           d_tab[:, 4], d_tab[:, 5], d_tab[:, 6], None, d_tab[:, 7], d_tab[:, 8])
    plane = torch.cat([d_plane4.new_zeros(3), d_plane4]) if has_plane else None
    return (None, *tab, d_sky6, plane)


def _radiance_ct(g_rad, p, dev):
    if g_rad is None:
        return torch.zeros((p, 3), dtype=torch.float32, device=dev)
    return g_rad.to(torch.float32).contiguous()


class _RegenTrace(torch.autograd.Function):
    """One recording forward (25 planes), kept for its backward."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        tables, sky6, plane7 = inputs[:11], inputs[11], inputs[12]
        call = spec.call(tables, sky6, plane7)
        rad, cnt, (resf, resi) = regen_forward(call, spec.sample_offset, True)
        ctx.save_for_backward(resf, resi)
        ctx.call, ctx.spec, ctx.has_plane = call, spec, plane7 is not None
        ctx.mark_non_differentiable(cnt)
        return rad, cnt

    @staticmethod
    def backward(ctx, g_rad, _g_cnt):
        resf, resi = ctx.saved_tensors
        call = ctx.call
        g = _radiance_ct(g_rad, call.pixel_ids.shape[0], resf.device)
        d = _bwd_from_residuals(call, ctx.spec.sample_offset, resf, resi, g)
        return _input_grads(*d, ctx.has_plane)


def _stream_forward(call, spec, keep_idx):
    """Idx-only forward over every chunk: summed radiance and counts, and
    the chunks' packed words when ``keep_idx``."""
    dev = call.pixel_ids.device
    rad = torch.zeros((call.pixel_ids.shape[0], 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((call.n_lanes,), dtype=torch.float32, device=dev)
    packs = []
    for off in spec.offsets():
        r, c, packed = regen_forward(call, off, False)
        rad, cnt = rad + r, cnt + c
        if keep_idx:
            packs.append(packed)
    return rad, cnt, packs


def _stream_backward(ctx, g_rad, packs):
    """Per chunk: (re-record,) re-forward, backward, bucket; sums in chunk
    order.  One chunk's planes are alive at a time."""
    call = ctx.call
    dev = call.pixel_ids.device
    g = _radiance_ct(g_rad, call.pixel_ids.shape[0], dev)
    d_tab = torch.zeros((call.n_spheres, 9), dtype=torch.float32, device=dev)
    d_sky = torch.zeros(6, dtype=torch.float32, device=dev)
    d_pl = torch.zeros(4, dtype=torch.float32, device=dev)
    for c, off in enumerate(ctx.spec.offsets()):
        packed = packs[c] if packs else regen_forward(call, off, False)[2]
        resf, resi = regen_refwd(call, off, packed)
        del packed
        dt, ds, dp = _bwd_from_residuals(call, off, resf, resi, g)
        del resf, resi
        d_tab, d_sky, d_pl = d_tab + dt, d_sky + ds, d_pl + dp
    return _input_grads(d_tab, d_sky, d_pl, ctx.has_plane)


class _RegenTraceStream(torch.autograd.Function):
    """Streamed-idx: packed winner words of every chunk kept; the backward
    re-forwards each chunk from them (no sphere scan)."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        tables, sky6, plane7 = inputs[:11], inputs[11], inputs[12]
        call = spec.call(tables, sky6, plane7)
        rad, cnt, packs = _stream_forward(call, spec, keep_idx=True)
        ctx.save_for_backward(*packs)
        ctx.call, ctx.spec, ctx.has_plane = call, spec, plane7 is not None
        ctx.mark_non_differentiable(cnt)
        return rad, cnt

    @staticmethod
    def backward(ctx, g_rad, _g_cnt):
        return _stream_backward(ctx, g_rad, list(ctx.saved_tensors))


class _RegenTraceCkstream(torch.autograd.Function):
    """Beyond the idx-plane budget: the forward keeps no words; the
    backward re-records each chunk's with the same kernel, so the replayed
    winners are the value pass's."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        tables, sky6, plane7 = inputs[:11], inputs[11], inputs[12]
        call = spec.call(tables, sky6, plane7)
        rad, cnt, _ = _stream_forward(call, spec, keep_idx=False)
        ctx.call, ctx.spec, ctx.has_plane = call, spec, plane7 is not None
        ctx.mark_non_differentiable(cnt)
        return rad, cnt

    @staticmethod
    def backward(ctx, g_rad, _g_cnt):
        return _stream_backward(ctx, g_rad, None)


def _trace_inputs(scene, camera, config):
    """Differentiable inputs (11 tables, sky6, plane7) and the detached
    camera block.  r^2 is scan-only and the plane's unit normal is not a
    parameter: both detached, as in the JAX package."""
    c, a = scene.centers, scene.albedo
    tables = (
        c[:, 0], c[:, 1], c[:, 2], scene.radii,
        (scene.radii * scene.radii).detach(), a[:, 0], a[:, 1], a[:, 2],
        scene.material.to(torch.int32), scene.fuzz, scene.ior,
    )
    sky6 = torch.cat([scene.sky_lo, scene.sky_hi])
    plane7 = None
    if scene.plane is not None:
        plane7 = torch.cat([scene.plane[:3].detach(), scene.plane[3:]])
    cam19 = camera_constants(camera, config.width, config.height).detach()
    return (*tables, sky6, plane7), cam19


def _spec(config, key, pixel_ids, cam19, sample_offset, n_samples, chunk, n_banks):
    return _Spec(
        pixel_ids=pixel_ids, cam19=cam19, key=key,
        sample_offset=int(sample_offset), n_samples=int(n_samples),
        chunk=int(chunk), max_depth=int(config.max_depth),
        width=int(config.width), height=int(config.height),
        t_min=float(config.t_min), t_max=float(config.t_max),
        rr_start_depth=int(config.rr_start_depth),
        n_banks=int(n_banks or GPU_BANKS),
    )


def render_block_grad_regen(scene, camera, config, key, pixel_ids,
                            sample_offset, n_samples, n_banks=None):
    """Differentiable per-pixel radiance SUM [P, 3] over ``n_samples``
    samples through one recording forward."""
    inputs, cam19 = _trace_inputs(scene, camera, config)
    spec = _spec(config, key, pixel_ids, cam19, sample_offset, n_samples,
                 n_samples, n_banks)
    rad, _ = _RegenTrace.apply(spec, *inputs)
    return rad


def render_block_grad_regen_stream(scene, camera, config, key, pixel_ids,
                                   sample_offset, n_samples, chunk,
                                   n_banks=None, checkpoint_idx=False):
    """Differentiable per-pixel radiance SUM [P, 3] over ``n_samples``
    samples by the streamed-idx scheme in ``chunk``-sample groups (bit for
    bit the radiance of ``render_block_grad_regen`` per chunk, summed in
    chunk order).  ``checkpoint_idx``: re-record the winner words in the
    backward instead of keeping them."""
    if n_samples % chunk:
        raise ValueError(f"n_samples={n_samples} is not a multiple of chunk={chunk}")
    inputs, cam19 = _trace_inputs(scene, camera, config)
    spec = _spec(config, key, pixel_ids, cam19, sample_offset, n_samples,
                 chunk, n_banks)
    trace = _RegenTraceCkstream if checkpoint_idx else _RegenTraceStream
    rad, _ = trace.apply(spec, *inputs)
    return rad
