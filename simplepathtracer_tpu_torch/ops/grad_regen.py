"""Regeneration gradient kernels: host side, wrappers, plain versions and the
differentiable traces built on them.

Counterpart of the JAX package's ``ops/pallas_grad_regen.py``, soft
silhouettes included (``RegenCall.softness`` > 0: the soft scan, its
blocker, the plane crossing coin).  A lane of the banked layout
(``persistent.bank_geometry``) runs its pixels' sample chains back to back:
when a path ends, the next iteration regenerates the next sample's camera
ray.  Iteration ``it`` of a lane is one bounce; the static budget
``n_iter`` (banks x samples x depth, rounded up to a multiple of 9) is the
worst case, so every chain completes.

Kernels (``csrc/grad_regen.cu``, ``csrc/bucket.cu``) and their plain
versions, each wrapper taking its plain version for a CPU tensor only:

* ``regen_forward`` / ``regen_fwd_reference`` -- the recording forward:
  per-position radiance sums (ascending sample order), per-lane live
  iteration counts, and either the 25 residual planes (``emit_full``; soft:
  30, the blocker's index and attributes appended) or only the winner
  indices packed three to an int32 word (soft: a second plane of blocker
  indices).
* ``regen_refwd`` / ``regen_refwd_reference`` -- the scan-free re-forward:
  the same state evolution with the sphere scan replaced by the recorded
  index; it emits the planes the ``emit_full`` forward would have.
* ``regen_backward`` / ``regen_bwd_reference`` -- the reverse walk: the
  9 winner-attribute cotangents per iteration (soft: and the blocker's 4)
  and per-lane sky (6) and plane (4) partial sums, through
  ``ops/bounce.py:bounce_tile_adjoint``.
* ``bucket.bucket_cols`` -- the attribute cotangents summed per sphere (the
  blocker's by blocker index).

Three ``torch.autograd.Function``s use them, as the JAX package's custom
VJPs do: ``_RegenTrace`` (one recording forward per spp chunk, planes kept
for its backward), ``_RegenTraceStream`` (idx-only forward over every
chunk, then per chunk a re-forward + backward) and ``_RegenTraceCkstream``
(the same, but the backward re-records each chunk's indices instead of
holding them all).

Residual planes are stored [plane, n_iter, n_lanes]: the 20 float planes
in ``resf`` and the 5 integer planes in ``resi`` (soft: 24 and 6;
``RESIDUAL_PLANES`` / ``SOFT_RESIDUAL_PLANES`` give the JAX order,
``residual_planes`` reassembles it).  Iterations after a lane's end read
as dead: ``alive`` 0, ``idx`` and ``bidx`` -1, packed words 0; the other
planes are not written there.  Winner codes: a sphere slot, -1 (miss or
dead), ``PLANE_IDX`` or, under soft silhouettes, ``PLANE_CROSS_IDX`` (the
plane won the crossing coin and the blocker slot holds the loser).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple

import torch

from . import bucket as _bucket
from .bounce import bounce_tile, bounce_tile_adjoint
from .closest_hit import sphere_attrs_plain, sphere_table
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
)
from . import intersect
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
# Soft silhouettes on a plane scene: the plane won the crossing coin against
# an in-band accepted sphere, which the lane's blocker slot then holds (the
# crossing loser; on every other lane the blocker is a rejected front
# sphere).  The forward records this role in the winner code, so the
# backward reads it instead of replaying the coins.  The JAX package writes
# PLANE_IDX here and replays the coins with thresholds it recomputes.
PLANE_CROSS_IDX = IDX_MASK - 2

# The 25 residual planes, in the JAX package's order (pallas_grad_regen.py);
# soft silhouettes append the blocker's 5.
RESIDUAL_PLANES = (
    "ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",   # entry ray, tp
    "alive", "regen", "kb", "s", "b",                      # masks, chain ids
    "idx", "mat",                                          # winner discrete
    "cx", "cy", "cz", "r", "ar", "ag", "ab", "fz", "io",    # winner attrs
)
SOFT_RESIDUAL_PLANES = RESIDUAL_PLANES + ("bidx", "bcx", "bcy", "bcz", "br")
# Which of the 25 (30) each resf (float) / resi (int32) plane holds.
_F_PLANES = tuple(range(11)) + tuple(range(16, 25))
_I_PLANES = tuple(range(11, 16))
_F_SOFT = _F_PLANES + (26, 27, 28, 29)
_I_SOFT = _I_PLANES + (25,)
# resf / resi index of the blocker's attributes and index (soft only).
_F_BLK = len(_F_PLANES)
_I_BLK = len(_I_PLANES)
_M32 = 0xFFFFFFFF
_MODES = {"full": 0, "idx": 1, "refwd": 2}
# Shared-memory bytes per sphere slot of the soft scan's table (float4).
_SMEM_SOFT_PER_SPHERE = 16


def residual_planes(resf, resi):
    """The 25 (soft: 30) [n_iter, n_lanes] planes in the JAX package's
    order."""
    soft = resf.shape[0] > len(_F_PLANES)
    names = SOFT_RESIDUAL_PLANES if soft else RESIDUAL_PLANES
    out = [None] * len(names)
    for k, j in enumerate(_F_SOFT if soft else _F_PLANES):
        out[j] = resf[k]
    for k, j in enumerate(_I_SOFT if soft else _I_PLANES):
        out[j] = resi[k]
    return out


def is_plane(idx):
    """Winner codes of a ground-plane hit (either role)."""
    return idx >= PLANE_CROSS_IDX


def _n_planes(call):
    """(float, int, cotangent) plane counts of one chunk's residuals."""
    if call.softness > 0.0:
        return len(_F_SOFT), len(_I_SOFT), 13
    return len(_F_PLANES), len(_I_PLANES), 9


class RegenCall(NamedTuple):
    """What one launch of the regen kernels reads, besides the sample
    offset: pixel ids, the [S_pad, 10] sphere table (cx cy cz r albedo rgb
    fuzz ior material), the f32[36] constants (sky 0:6, plane 6:13, camera
    13:32; the soft constants of ``scene_block`` at 32:36), the key words and the static shape of the lane
    layout.  Under soft silhouettes (``softness`` > 0) also the soft scan's
    [S_pad, 4] table ``soft_tab`` (the JAX package's ``soft_scan_tables``:
    silhouette scale, 1 / r^2, validity scale, -30 x validity scale),
    computed once here so the kernel and its plain version read the same
    thresholds."""

    pixel_ids: torch.Tensor
    tab: torch.Tensor
    consts: torch.Tensor
    soft_tab: torch.Tensor | None
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
    softness: float


def scene_block(tables, sky6, softness=0.0):
    """What the gradient kernels read of the scene, values only: the
    [S_pad, 10] table (``closest_hit.sphere_table``), the sky and the soft
    constants (f32[6] and f32[4]: softness, softness x 8 and softness x 0.1,
    each rounded to float32 once, as the plain versions round them, and the
    ``SIL_FRESNEL`` flag, 1.0 or 0.0) and, under soft silhouettes, the soft
    scan's [S_pad, 4] table (the JAX package's ``soft_scan_tables``:
    silhouette scale, 1 / r^2, validity scale, -30 x validity scale),
    computed once here so the kernels and their plain versions read the
    same thresholds.

    The flag is ``intersect.SIL_FRESNEL``, read here, when the call is
    built (the JAX package reads it when it traces the kernel), and holds
    only under soft silhouettes: the backward then adds the detached
    Schlick-coin ratio's score (``ops/bounce.py:_fresnel_adjoint``); no
    forward value changes."""
    f32 = torch.float32
    softness = float(softness)
    fresnel = softness > 0.0 and bool(intersect.SIL_FRESNEL)
    tab = sphere_table(tables)
    with torch.no_grad():
        soft4 = tab.new_tensor([
            _f32(softness), _f32(softness * intersect._SIL_R0),
            _f32(softness * intersect._SIG_V0), 1.0 if fresnel else 0.0,
        ])
        soft_tab = None
        if softness > 0.0:
            # Padding slots have a NaN radius: NaN scale and 1 / r^2, so
            # every test of theirs fails (their validity rows are finite).
            r = tab[:, 3]
            sigv = intersect.validity_scale(softness, r)
            soft_tab = torch.stack(
                [intersect.silhouette_scale(softness, r), 1.0 / (r * r), sigv, -30.0 * sigv],
                dim=1,
            ).contiguous()
    return tab, sky6.detach().to(f32), soft4, soft_tab


def fresnel_on(call) -> bool:
    """Whether a regen or fused call's constants turn ``SIL_FRESNEL`` on
    (their last entry, set by ``scene_block``)."""
    return bool(call.consts[-1] > 0.0)


def regen_call(tables, sky6, plane7, cam19, key, pixel_ids, *, n_samples,
               max_depth, width, height, t_min=1e-3, t_max=3.0e7,
               rr_start_depth=0, n_banks=GPU_BANKS, softness=0.0) -> RegenCall:
    """A ``RegenCall`` from the 11 sphere tables (cx, cy, cz, radius,
    radius^2, albedo rgb, material, fuzz, ior), sky f32[6], plane f32[7] or
    None, camera f32[19] and key (values only: nothing here is
    differentiated)."""
    f32 = torch.float32
    softness = float(softness)
    tab, sky, soft4, soft_tab = scene_block(tables, sky6, softness)
    with torch.no_grad():
        plane = (plane7.detach() if plane7 is not None
                 else torch.zeros(7, dtype=f32, device=tab.device))
        consts = torch.cat([sky, plane.to(f32), cam19.detach().to(f32), soft4]).contiguous()
    p = pixel_ids.shape[0]
    nb, n_lanes = bank_geometry(p, n_banks)
    budget = nb * int(n_samples) * int(max_depth)
    k0, k1 = key_words(key)
    return RegenCall(
        pixel_ids=pixel_ids.to(torch.int32).contiguous(), tab=tab,
        consts=consts, soft_tab=soft_tab, k0=k0, k1=k1, n_spheres=tables[0].shape[0],
        use_plane=plane7 is not None, n_samples=int(n_samples),
        max_depth=int(max_depth), width=int(width), height=int(height),
        t_min=float(t_min), t_max=float(t_max),
        rr_start_depth=int(rr_start_depth), n_banks=nb, n_lanes=n_lanes,
        n_iter=-(-budget // CHUNK) * CHUNK, softness=softness,
    )


# --------------------------------------------------------------------------
# Wrappers


def variant(call: RegenCall) -> str:
    """The kernel instantiation a call launches: ``hard``, ``soft`` or
    ``soft_plane`` (soft silhouettes with a ground plane: the crossing
    coin)."""
    if call.softness <= 0.0:
        return "hard"
    return "soft_plane" if call.use_plane else "soft"


def _device(call: RegenCall) -> torch.device:
    dev = call.pixel_ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_cuda(call: RegenCall, *tensors):
    dev = call.pixel_ids.device
    extra = () if call.soft_tab is None else (call.soft_tab,)
    for t in (call.tab, call.consts, *extra, *tensors):
        if t.device != dev:
            raise ValueError(f"all inputs must lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    p, s_pad = call.pixel_ids.shape[0], call.tab.shape[0]
    if p == 0 or p >= 2**31 or call.n_iter * call.n_lanes >= 2**31:
        raise ValueError(f"pixel count {p} or plane size out of range")
    per_sphere = _SMEM_PER_SPHERE + (_SMEM_SOFT_PER_SPHERE if call.softness > 0.0 else 0)
    if s_pad == 0 or s_pad * per_sphere > _MAX_SMEM:
        raise ValueError(f"{s_pad} sphere slots do not fit a block's shared memory")
    if (call.softness > 0.0) != (call.soft_tab is not None) or (
        call.soft_tab is not None and call.soft_tab.shape != (s_pad, 4)
    ):
        raise ValueError("soft_tab must be [S_pad, 4] exactly when softness > 0")
    if s_pad > IDX_PACK_MAX_SPHERES:
        raise ValueError(
            f"{s_pad} sphere slots exceed the {IDX_PACK_MAX_SPHERES} the "
            "10-bit winner code holds"
        )
    if call.consts.shape != (36,) or call.tab.shape[1] != 10:
        raise ValueError("consts must be f32[36] and the table [S, 10]")
    if not 0 < call.max_depth <= 30 or call.n_samples < 1:
        raise ValueError("need 0 < max_depth <= 30 and n_samples >= 1")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_forward(call, sample_offset, mode, idx_in, rad, cnt, resf, resi,
                    packed, counters=None):
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
            _MODES[mode], call.softness, _ptr(call.soft_tab), _ptr(idx_in),
            _ptr(rad), _ptr(cnt), _ptr(resf), _ptr(resi), _ptr(packed),
            _ptr(counters), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"regen {mode} kernel launch failed: CUDA error {err}")


def _packed_shape(call: RegenCall):
    """Packed words of one chunk: [n_iter / 3, n_lanes] winners, or under
    soft silhouettes [2, n_iter / 3, n_lanes] (winners, blockers)."""
    shape = (call.n_iter // IDX_PACK, call.n_lanes)
    return (2, *shape) if call.softness > 0.0 else shape


def regen_forward(call: RegenCall, sample_offset, emit_full: bool, counters=None):
    """Recording forward over ``call.n_samples`` samples from
    ``sample_offset``.  Returns (radiance sums [P, 3], live iterations per
    lane [n_lanes] f32, residuals): ``(resf [20, n_iter, n_lanes] f32,
    resi [5, n_iter, n_lanes] int32)`` with ``emit_full`` (soft: 24 and 6
    planes, the blocker's appended), else the packed winner words
    (``_packed_shape``).

    Without ``emit_full`` the kernel's threads fetch lanes from a counter
    and write no word after a lane's end, so the words are zeroed here
    first.  ``counters``, an int64 [3] tensor on the card that the caller
    may pass for an idx-only launch, is zeroed and receives that launch's
    counters: lanes fetched (n_lanes plus one per thread that found none),
    thread-iterations (32 per loop trip of a warp; against the sum of the
    counts it gives the share of thread slots that ran a lane) and the
    resident grid's blocks.  Without it the wrapper allocates its own."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_fwd_reference(call, sample_offset, emit_full)
    if counters is None:
        _check_cuda(call)
    elif emit_full or counters.shape != (3,) or counters.dtype != torch.int64:
        raise ValueError("counters: int64 [3], for an idx-only launch")
    else:
        _check_cuda(call, counters)
    p, b, n = call.pixel_ids.shape[0], call.n_iter, call.n_lanes
    nf, ni, _ = _n_planes(call)
    rad = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((n,), dtype=torch.float32, device=dev)
    resf = resi = packed = None
    if emit_full:
        resf = torch.empty((nf, b, n), dtype=torch.float32, device=dev)
        resi = torch.empty((ni, b, n), dtype=torch.int32, device=dev)
    else:
        packed = torch.zeros(_packed_shape(call), dtype=torch.int32, device=dev)
        if counters is None:
            counters = torch.zeros((3,), dtype=torch.int64, device=dev)
        else:
            counters.zero_()
    _launch_forward(call, sample_offset, "full" if emit_full else "idx", None,
                    rad, cnt, resf, resi, packed, counters)
    regen_forward.launches[variant(call)] += 1
    return rad, cnt, ((resf, resi) if emit_full else packed)


# Launches of the kernel, by variant.
regen_forward.launches = Counter()


def regen_refwd(call: RegenCall, sample_offset, packed):
    """Scan-free re-forward from the packed winner words of one chunk:
    ``(resf, resi)`` as ``regen_forward(emit_full=True)`` gives them."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_refwd_reference(call, sample_offset, packed)
    _check_cuda(call, packed)
    b, n = call.n_iter, call.n_lanes
    if packed.shape != _packed_shape(call) or packed.dtype != torch.int32:
        raise ValueError(f"packed words must be int32 {list(_packed_shape(call))}")
    nf, ni, _ = _n_planes(call)
    resf = torch.empty((nf, b, n), dtype=torch.float32, device=dev)
    resi = torch.empty((ni, b, n), dtype=torch.int32, device=dev)
    _launch_forward(call, sample_offset, "refwd", packed, None, None, resf,
                    resi, None)
    regen_refwd.launches[variant(call)] += 1
    return resf, resi


regen_refwd.launches = Counter()


def regen_backward(call: RegenCall, sample_offset, resf, resi, ct_rad):
    """Reverse walk over one chunk's residual planes with the radiance
    cotangent ``ct_rad`` [P, 3].  Returns (attribute cotangents
    [9, n_iter, n_lanes] f32, zero where idx < 0 -- soft: 13, the
    blocker's cx cy cz r appended, zero where bidx < 0; per-lane partials
    [10, n_lanes] f32: sky lo/hi rgb, then plane offset and albedo rgb).

    The planes must be as a recording forward or re-forward writes them:
    each lane's alive column 1 on iterations 0 .. count - 1 and 0 after
    (``tests/test_torch_regen_counts.py`` holds them to it).  The kernel
    finds each lane's count by a binary search over that column and
    disagrees with ``regen_bwd_reference``, which reads every iteration's
    alive, on a column that is not a prefix."""
    dev = _device(call)
    if dev.type == "cpu":
        return regen_bwd_reference(call, sample_offset, resf, resi, ct_rad)
    ct_rad = ct_rad.to(torch.float32).contiguous()
    _check_cuda(call, resf, resi, ct_rad)
    b, n = call.n_iter, call.n_lanes
    nf, ni, nc = _n_planes(call)
    if resf.shape != (nf, b, n) or resi.shape != (ni, b, n) or (
        ct_rad.shape != (call.pixel_ids.shape[0], 3)
    ):
        raise ValueError("residual planes or radiance cotangent mis-shaped")
    ct_planes = torch.empty((nc, b, n), dtype=torch.float32, device=dev)
    partials = torch.empty((10, n), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_regen_backward(
            call.pixel_ids.data_ptr(), call.pixel_ids.shape[0], n,
            call.n_banks, call.consts.data_ptr(), int(call.use_plane),
            call.k0, call.k1, int(sample_offset) & _M32, b, call.t_min,
            call.t_max, call.rr_start_depth, call.softness, resf.data_ptr(),
            resi.data_ptr(), ct_rad.data_ptr(), ct_planes.data_ptr(),
            partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"regen backward kernel launch failed: CUDA error {err}")
    regen_backward.launches[variant(call)] += 1
    return ct_planes, partials


regen_backward.launches = Counter()


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


def _crossing_uniforms(call: RegenCall, pix, samp, b):
    """The crossing and validity coins (ux, uv) of bounce ``b``: slot
    128 + b (ops/sampling.py:crossing_noise)."""
    w0, w1 = threefry2x32(call.k0, call.k1, pix, ((samp << 8) & _M32) | (128 + b))
    return _to_unit_float(w0), _to_unit_float(w1)


def _winner(call: RegenCall, idx):
    """The winner's 9 attributes and material for indices ``idx`` [N]: a
    sphere slot, the ground plane (either plane code: normal, offset,
    albedo; fuzz 0, ior 1) or a miss (-1: the scan's defaults r = 1,
    ior = 1)."""
    attr, mat = sphere_attrs_plain(call.tab, idx)
    if call.use_plane:
        pm = is_plane(idx)
        plane9 = torch.cat([call.consts[6:13], attr.new_tensor([0, 1])])
        attr = torch.where(pm[None, :], plane9[:, None], attr)
        mat = torch.where(pm, 0, mat)
    return tuple(attr.unbind(0)), mat.to(torch.int64)


def _blocker(call: RegenCall, bidx):
    """The blocker's (cx, cy, cz, r) for indices ``bidx`` [N]; zeros for
    none (-1)."""
    tab = call.tab
    rows = tab[bidx.clamp(0, tab.shape[0] - 1), :4]
    vals = torch.where((bidx >= 0)[:, None], rows, torch.zeros_like(rows))
    return tuple(vals[:, j] for j in range(4))


def _plane_t(call: RegenCall, o, d):
    """The ground plane's (t, live) per ray (plane_override's formula)."""
    pl = call.consts[6:13].tolist()
    denom = d[0] * pl[0] + d[1] * pl[1] + d[2] * pl[2]
    num = -(o[0] * pl[0] + o[1] * pl[1] + o[2] * pl[2] + pl[3])
    live = torch.abs(denom) > 1e-8
    return num / torch.where(live, denom, torch.ones_like(denom)), live


def _scan_soft(call: RegenCall, o, d, u7, ux, uv, prev):
    """The soft scan of the kernels (closest_hit_soft in csrc/common.cuh,
    the JAX package's closest_hit_scan_soft and plane_override with
    ``thr_x``): (winner code [N], blocker index [N]; -1 for none).

    Sphere s is accepted iff disc > logit(u7) * scale_s and its raw root
    beats the validity coin t_min + logit(uv) * sigma_v,s (hard t_min for
    the chain's previous winner ``prev``); the winner is the nearest
    accepted sphere at t = max(t_raw, t_min), first on ties.  The blocker
    is the rejected sphere of largest disc / r^2 (first on ties) whose t
    beats the running best accepted t before it and whose raw root lies
    above t_min - 30 sigma_v.  The one-pass running minimum is an exclusive
    cumulative minimum here; padding slots (NaN radius) fail every test.
    On plane scenes the plane wins unless the sphere winner beats it by
    the crossing coin, t_s < t_p + logit(ux) * sigma_x(r_s); where the plane
    wins against a sphere less than 30 sigma_x behind, that sphere becomes
    the blocker and the winner code is PLANE_CROSS_IDX."""
    tab, st = call.tab, call.soft_tab
    t_min, t_max = call.t_min, call.t_max
    s_pad = tab.shape[0]
    ocx = tab[None, :, 0] - o[0][:, None]
    ocy = tab[None, :, 1] - o[1][:, None]
    ocz = tab[None, :, 2] - o[2][:, None]
    tc = ocx * d[0][:, None] + ocy * d[1][:, None] + ocz * d[2][:, None]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    rad = tab[:, 3]
    disc = (rad * rad)[None, :] - (oc2 - tc * tc)
    sq = torch.sqrt(torch.maximum(disc, disc.new_tensor(1e-12)))
    t_near = tc - sq
    t_raw = torch.where(t_near > t_min, t_near, tc + sq)
    t = torch.maximum(t_raw, t_raw.new_tensor(t_min))
    lgt = intersect.silhouette_logit(u7)
    lgtv = intersect.silhouette_logit(uv)
    is_prev = prev[:, None] == torch.arange(s_pad, device=prev.device)[None, :]
    zero = disc.new_tensor(0.0)
    thr_v = torch.where(is_prev, zero, lgtv[:, None] * st[None, :, 2])
    gate = torch.where(is_prev, zero, st[None, :, 3].expand_as(disc))
    valc = (t_raw > t_min + thr_v) & (t_raw < t_max)
    accept = (disc > lgt[:, None] * st[None, :, 0]) & valc
    t_sel = torch.where(accept, t, t.new_tensor(t_max))
    bi = torch.argmin(t_sel, dim=1)
    bt = torch.gather(t_sel, 1, bi[:, None])[:, 0]
    hit = bt < t_max
    cmin = torch.cummin(t_sel, dim=1).values
    bt_before = torch.cat([torch.full_like(cmin[:, :1], t_max), cmin[:, :-1]], dim=1)
    cand = ~accept & (t_raw > t_min + gate) & (t < bt_before)
    score = torch.where(cand, disc * st[None, :, 1], disc.new_tensor(float("-inf")))
    qi = torch.argmax(score, dim=1)
    qi = torch.where(cand.any(dim=1), qi, -1)
    bi = torch.where(hit, bi, -1)
    if call.use_plane:
        tpl, live = _plane_t(call, o, d)
        pre_r = torch.where(hit, rad[bi.clamp(min=0)], rad.new_tensor(1.0))
        sigx = intersect.crossing_scale(call.softness, pre_r)
        thr_x = intersect.silhouette_logit(ux) * sigx
        wins = (live & (tpl > t_min) & (tpl < t_max)
                & ~((bi >= 0) & (bt < tpl + thr_x)))
        steal = wins & (bi >= 0) & (bt - tpl < 30.0 * sigx)
        qi = torch.where(steal, bi, qi)
        bi = torch.where(wins, torch.where(steal, PLANE_CROSS_IDX, PLANE_IDX), bi)
    return bi, qi


def _scan_winner(call: RegenCall, o, d):
    """Winner index per ray: closest sphere, then the ground plane where it
    is nearer (PLANE_IDX); -1 on a miss."""
    tab = call.tab
    bt, bi, hit = closest_hit_plain(
        *o, *d, tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 3], call.t_min, call.t_max
    )
    bi = torch.where(hit, bi, -1)
    if call.use_plane:
        tpl, live = _plane_t(call, o, d)
        wins = live & (tpl > call.t_min) & (tpl < bt)
        bi = torch.where(wins, PLANE_IDX, bi)
    return bi


def _pack(word, v, field):
    """Add code ``v`` (idx + 1, 10 bits) into field ``field`` of ``word``."""
    return v if field == 0 else word + v * (1 << (IDX_BITS * field))


def _unpack(words, it):
    """The index recorded at iteration ``it`` of packed words [n_iter / 3, N]."""
    w = words[it // IDX_PACK].to(torch.int64)
    return ((w >> (IDX_BITS * (it % IDX_PACK))) & IDX_MASK) - 1


def _replay(call: RegenCall, sample_offset, mode: str, packed_in=None):
    """The regen kernels' state evolution over all lanes at once.  ``mode``:
    'full' / 'idx' (recording forward; winners from the scan) or 'refwd'
    (winners, and under soft silhouettes blockers, from ``packed_in``)."""
    dev = call.pixel_ids.device
    f32, i64 = torch.float32, torch.int64
    n, b_total, nb = call.n_lanes, call.n_iter, call.n_banks
    p = call.pixel_ids.shape[0]
    soft = call.softness > 0.0
    lanes = torch.arange(n, device=dev)
    pixb, _ = _lane_pixels(call)
    sky6 = tuple(call.consts[i] for i in range(6))
    rr_on = bool(call.rr_start_depth)
    zero, one = torch.zeros(n, dtype=f32, device=dev), torch.ones(n, dtype=f32, device=dev)
    kb, s, b = (torch.zeros(n, dtype=i64, device=dev) for _ in range(3))
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = torch.full((n,), -1, dtype=i64, device=dev)
    o, d, tp = (zero,) * 3, (zero, zero, one), (one,) * 3
    acc = (zero,) * 3
    cnt = zero
    rad_out = torch.zeros((p, 3), dtype=f32, device=dev)
    planes = mode != "idx"
    nf, ni, _ = _n_planes(call)
    if planes:
        resf = torch.empty((nf, b_total, n), dtype=f32, device=dev)
        resi = torch.empty((ni, b_total, n), dtype=torch.int32, device=dev)
    else:
        packed = torch.zeros(_packed_shape(call), dtype=torch.int32, device=dev)
        words = packed.view(-1, b_total // IDX_PACK, n)
        word = [torch.zeros(n, dtype=i64, device=dev) for _ in range(words.shape[0])]
    if packed_in is not None:
        packed_in = packed_in.view(-1, b_total // IDX_PACK, n)
    plane4 = None
    if call.use_plane:
        plane4 = tuple(call.consts[6 + j] for j in range(4))
    fresnel = fresnel_on(call)
    soff = int(sample_offset)
    for it in range(b_total):
        regen = ~alive & (kb < nb)
        if not bool((alive | regen).any()):
            # Every lane is done: the remaining iterations are dead.
            if planes:
                resf[9, it:] = 0.0
                resi[3, it:] = -1
                if soft:
                    resi[_I_BLK, it:] = -1
            elif it % IDX_PACK:
                for k, w in enumerate(word):
                    words[k, it // IDX_PACK] = w.to(torch.int32)
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
            prev = torch.where(regen, -1, prev)
            alive = alive | regen
        cnt = cnt + alive.to(f32)
        if planes:
            for c in range(3):
                resf[c, it], resf[3 + c, it], resf[6 + c, it] = o[c], d[c], tp[c]
            resf[9, it] = alive.to(f32)
            resf[10, it] = regen.to(f32)
            resi[0, it], resi[1, it], resi[2, it] = kb, s, b
        u = _bounce_uniforms(call, pix, samp, b)
        bidx = None
        if mode == "refwd":
            idx = _unpack(packed_in[0], it)
            if soft:
                bidx = _unpack(packed_in[1], it)
        elif soft:
            ux, uv = _crossing_uniforms(call, pix, samp, b)
            idx, bidx = _scan_soft(call, o, d, u[7], ux, uv, prev)
        else:
            idx = _scan_winner(call, o, d)
        idx = torch.where(alive, idx, -1)
        a9, mat = _winner(call, idx)
        hit = idx >= 0
        codes = [idx]
        if soft:
            bidx = torch.where(alive, bidx, -1)
            blk4 = _blocker(call, bidx)
            codes.append(bidx)
        if planes:
            resi[3, it], resi[4, it] = idx, mat
            for j in range(9):
                resf[11 + j, it] = a9[j]
            if soft:
                resi[_I_BLK, it] = bidx
                for j in range(4):
                    resf[_F_BLK + j, it] = blk4[j]
        else:
            field = it % IDX_PACK
            for k, v in enumerate(codes):
                word[k] = _pack(word[k], v + 1, field)
                if field == IDX_PACK - 1:
                    words[k, it // IDX_PACK] = word[k].to(torch.int32)

        pm = is_plane(idx) if call.use_plane else None
        kw = {}
        if soft:
            kw = dict(softness=call.softness, blocker=(bidx >= 0, *blk4),
                      fresnel=fresnel)
            if call.use_plane:
                kw.update(plane4=plane4, cross_loser=idx == PLANE_CROSS_IDX)
        o, d, tp, rad3, surv_f = bounce_tile(
            o, d, tp, a9, mat, hit, alive, u, sky6, b >= call.rr_start_depth,
            t_min=call.t_min, t_max=call.t_max, rr_on=rr_on, plane_mask=pm, **kw,
        )
        if soft:
            # The chain's previous sphere winner (-1 after a plane or a miss).
            prev = torch.where(hit & ~pm if pm is not None else hit, idx, -1)
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
    soft = call.softness > 0.0
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
    ct_planes = torch.zeros((_n_planes(call)[2], b_total, n), dtype=f32, device=dev)
    plane4 = tuple(call.consts[6 + j] for j in range(4)) if call.use_plane else None
    fresnel = fresnel_on(call)
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
        pm = is_plane(idx) if call.use_plane else None
        kw = {}
        if soft:
            bval = resi[_I_BLK, it] >= 0
            kw = dict(softness=call.softness,
                      blocker=(bval, *(resf[_F_BLK + j, it] for j in range(4))),
                      fresnel=fresnel)
            if call.use_plane:
                kw.update(plane4=plane4, cross_loser=idx == PLANE_CROSS_IDX)
        ctr = tuple(ctb[kb, lanes, c] for c in range(3))
        g = bounce_tile_adjoint(
            tuple(resf[c, it] for c in range(3)),
            tuple(resf[3 + c, it] for c in range(3)),
            tuple(resf[6 + c, it] for c in range(3)),
            tuple(resf[11 + j, it] for j in range(9)),
            mat, hit, alive, u, sky6, b >= call.rr_start_depth,
            co, cd, ctp, ctr,
            t_min=call.t_min, t_max=call.t_max, rr_on=rr_on, plane_mask=pm, **kw,
        )
        for j in range(9):
            ct_planes[j, it] = torch.where(hit, g.a9[j], zero)
        if soft:
            for j in range(4):
                ct_planes[9 + j, it] = torch.where(bval, g.blk4[j], zero)
        sky_part = tuple(a + x for a, x in zip(sky_part, g.sky))
        if pm is not None:
            if soft:
                # The offset also moves the crossing coin's probability on
                # sphere-win lanes.
                pl_part = (pl_part[0] + g.pk,) + pl_part[1:]
            pl_part = tuple(a + torch.where(pm, x, zero)
                            for a, x in zip(pl_part, g.a9[3:7]))
        # A chain's camera ray starts here: its carried cotangents restart.
        regen = alive & (resf[10, it] > 0.0)
        co, cd, ctp = (tuple(torch.where(regen, zero, x) for x in gs)
                       for gs in (g.o, g.d, g.tp))
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
    softness: float

    def call(self, tables, sky6, plane7) -> RegenCall:
        return regen_call(
            tables, sky6, plane7, self.cam19, self.key, self.pixel_ids,
            n_samples=self.chunk, max_depth=self.max_depth, width=self.width,
            height=self.height, t_min=self.t_min, t_max=self.t_max,
            rr_start_depth=self.rr_start_depth, n_banks=self.n_banks,
            softness=self.softness,
        )

    def offsets(self):
        return [self.sample_offset + c * self.chunk
                for c in range(self.n_samples // self.chunk)]


def _bwd_from_residuals(call, sample_offset, resf, resi, g_rad):
    """Backward kernel + bucket over one chunk's planes: (d_tab [S, 9],
    d_sky6 [6], d_plane4 [4] = offset + albedo rgb).  Under soft
    silhouettes the blocker's 4 cotangent planes are bucketed by blocker
    index into the (cx, cy, cz, r) columns."""
    ct_planes, partials = regen_backward(call, sample_offset, resf, resi, g_rad)
    d_tab = _bucket.bucket_cols(ct_planes[:9], resi[3], call.n_spheres)
    if call.softness > 0.0:
        d_blk = _bucket.bucket_cols(ct_planes[9:], resi[_I_BLK], call.n_spheres)
        d_tab = torch.cat([d_tab[:, :4] + d_blk, d_tab[:, 4:]], dim=1)
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


def scene_inputs(scene):
    """The scene's differentiable inputs of the gradient kernels: (11
    tables, sky6, plane7 or None).  r^2 is scan-only and the plane's unit
    normal is not a parameter: both detached, as in the JAX package."""
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
    return (*tables, sky6, plane7)


def _trace_inputs(scene, camera, config):
    """Differentiable inputs (``scene_inputs``) and the detached camera
    block."""
    cam19 = camera_constants(camera, config.width, config.height).detach()
    return scene_inputs(scene), cam19


def _spec(config, key, pixel_ids, cam19, sample_offset, n_samples, chunk, n_banks):
    return _Spec(
        pixel_ids=pixel_ids, cam19=cam19, key=key,
        sample_offset=int(sample_offset), n_samples=int(n_samples),
        chunk=int(chunk), max_depth=int(config.max_depth),
        width=int(config.width), height=int(config.height),
        t_min=float(config.t_min), t_max=float(config.t_max),
        rr_start_depth=int(config.rr_start_depth),
        n_banks=int(n_banks or GPU_BANKS),
        softness=float(config.silhouette_softness),
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
