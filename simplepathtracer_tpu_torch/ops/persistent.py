"""Persistent whole-render kernel: host side, wrapper and plain version.

Counterpart of the JAX package's ``ops/pallas_persistent.py`` (and the host
side of ``ops/pallas_common.py``).  ``render_block_persistent`` returns, for
each pixel id, the radiance SUM over ``n_samples`` consecutive sample ids
and optionally the number of bounce iterations those samples executed (the
cost signal of the lane balancer).  With an ``emission`` table that has a
non-zero entry, every sphere hit also adds the path's throughput times the
winner's emission (the kernel's ``kEmit`` build; the JAX package has no
emission).

On a CUDA tensor it launches the hand-written kernel in
``csrc/persistent.cu``; on a CPU tensor it calls the plain PyTorch version
``render_block_persistent_reference``, which computes the same function in
the kernel's formulation (direct |oc|^2, camera rays from the f32[19]
block, exp(log(u)/3) cube root), so that the two differ by rounding only.
Both split a pixel's samples into ``sample_groups(n_samples)`` groups of
``SAMPLE_GROUP``, sum each group in sample order and add the groups in
order, so the kernel's work items are short and its sums are fixed.

The kernel is built from the sources in ``csrc/`` at first use
(``ops/cuda_build.py``: nvcc for sm_90a, a plain C interface, ctypes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import tracing
from ..types import Material, nonzero_rows
from .cuda_build import load_library
from .sampling import _f32, key_words, threefry2x32, _to_unit_float

# Lanes are laid out in blocks of this many positions: fewer pixels than one
# block give a single bank (the JAX package's (8, 128) tile, kept so that the
# position -> (bank, lane) map matches it).
BLOCK = 1024
# Pixel banks per lane of the regeneration kernels (``grad_regen_banks``'s
# default); the persistent kernel fetches positions from a counter.
GPU_BANKS = 1

# Shared memory one block may use on an H100 (227 KB).
_MAX_SMEM = 232448
TABLE_SLOT_BYTES = 40   # a [S_pad, 10] table slot: float4 + float4 + float2
# (pixel, sample) rays x spheres per plain-version chunk.
_PLAIN_CHUNK_ELEMS = 1 << 24
# Samples of one work item of the persistent kernel (the last group of a
# pixel may be shorter), from a sweep on an H100 (PERF.md, PR 21): 32 and
# 64 were 1-7% slower on the render cells' frames, 8 and 12 within 1% of 16
# there and 8 slower on smallpt's.  The partial sums take 12 B (16 with
# counts) a pixel and group, about 0.75 B a path.
SAMPLE_GROUP = 16


def sample_groups(n_samples: int) -> int:
    """The groups of ``SAMPLE_GROUP`` consecutive samples that a launch of
    ``n_samples`` splits each pixel's samples into: 1 up to
    ``SAMPLE_GROUP``, else ceil(n_samples / SAMPLE_GROUP).  It depends on
    ``n_samples`` alone, so a pixel's sum does not depend on which launch,
    block or rank renders it."""
    return -(-int(n_samples) // SAMPLE_GROUP)


def bank_geometry(p: int, n_banks: int) -> tuple[int, int]:
    """(n_banks, n_lanes) of the banked layout for ``p`` positions: lane l
    serves positions l + k * n_lanes for k < n_banks (positions >= p are
    masked).  Same map as the JAX package's ``banked_lane_layout``."""
    n_banks = int(min(n_banks, max(1, p // BLOCK)))
    return n_banks, -(-p // n_banks)


def check_smem(slots: int, slot_bytes: int, fixed_bytes: int = 0) -> None:
    """Raise ``ValueError`` unless a table of ``slots`` slots of
    ``slot_bytes`` bytes, beside ``fixed_bytes`` more, fits one block's
    shared memory; a table needs one slot at least."""
    need = slots * slot_bytes + fixed_bytes
    if slots == 0 or need > _MAX_SMEM:
        raise ValueError(f"{slots} sphere slots need {need} B of shared memory; "
                         f"a block has {_MAX_SMEM} B")


def sphere_table(tables) -> torch.Tensor:
    """The kernels' [S_pad, 10] sphere table (cx cy cz r albedo rgb fuzz ior
    material, padded as ``pad_scene_tables``) from the 11 [S] tables,
    values only."""
    with torch.no_grad():
        cx, cy, cz, rad, _r2, ar, ag, ab, mat, fz, io = pad_scene_tables(
            [t.detach() for t in tables]
        )
        return torch.stack(
            [cx, cy, cz, rad, ar, ag, ab, fz, io, mat.to(torch.float32)], dim=1
        ).to(torch.float32).contiguous()


def emit_table(emission, s_pad: int):
    """The [s_pad, 4] emission table the emissive builds read (rgb, 0;
    padding slots dark) from ``emission`` [S, 3], values only; None for
    None."""
    if emission is None:
        return None
    with torch.no_grad():
        emit = torch.zeros((s_pad, 4), dtype=torch.float32, device=emission.device)
        emit[:emission.shape[0], :3] = emission.detach()
    return emit


def pad_scene_tables(tables, multiple: int = 4):
    """Pad the 11 sphere tables to a multiple of ``multiple`` slots (the
    kernel's scan unroll).  Padding slots carry a NaN radius: the scan
    recomputes r^2 = r * r, so their discriminant is NaN for every ray and
    they reject themselves."""
    s = tables[0].shape[0]
    pad = (-s) % multiple
    if pad == 0:
        return tuple(tables)
    out = []
    for i, t in enumerate(tables):
        fill = float("nan") if i in (3, 4) else 0
        out.append(torch.cat([t, torch.full((pad,), fill, dtype=t.dtype, device=t.device)]))
    return tuple(out)


def camera_constants(cam, width, height) -> torch.Tensor:
    """The f32[19] camera block: origin 0:3, lower_left 3:6, horizontal
    6:9, vertical 9:12, u 12:15, v 15:18, lens radius 18."""
    from ..camera import view_frame

    u, v, lower_left, horizontal, vertical = view_frame(cam, width, height)
    lens = (0.5 * cam.aperture).reshape(1)
    return torch.cat(
        [cam.origin, lower_left, horizontal, vertical, u, v, lens]
    ).to(torch.float32)


# --------------------------------------------------------------------------
# Wrapper


def render_block_persistent(
    pixel_ids, scene_tables, sky6, cam19, key2, sample_offset,
    n_samples, max_depth, width, height,
    t_min=1e-3, t_max=3.0e7, rr_start_depth=0, return_counts=False,
    plane7=None, emission=None,
):
    """Radiance SUM over ``n_samples`` samples for each pixel id: [P, 3] f32,
    and with ``return_counts`` also [P] f32 bounce iterations per pixel.

    pixel_ids: [P] int — global pixel ids (y * width + x).
    scene_tables: 11 [S] tensors (cx, cy, cz, radius, radius^2, albedo rgb,
    material, fuzz, ior); sky6: f32[6]; cam19: f32[19] (camera_constants);
    key2: two u32 words; plane7: f32[7] or None; emission: f32[S, 3] or
    None (an all-zero table renders as None does, bit for bit).

    On a CPU tensor this is the plain version.  On a CUDA tensor it
    launches the kernel (the emissive build where ``emission`` has a
    non-zero entry), or raises.
    """
    if emission is not None and not nonzero_rows(emission):
        emission = None
    if pixel_ids.device.type == "cpu":
        return render_block_persistent_reference(
            pixel_ids, scene_tables, sky6, cam19, key2, sample_offset,
            n_samples, max_depth, width, height, t_min=t_min, t_max=t_max,
            rr_start_depth=rr_start_depth, return_counts=return_counts,
            plane7=plane7, emission=emission,
        )
    if pixel_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {pixel_ids.device}")
    dev = pixel_ids.device
    if pixel_ids.dim() != 1 or pixel_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("pixel_ids must be a 1-D int32/int64 tensor")
    p = pixel_ids.shape[0]
    if p == 0 or p >= 2**31:
        raise ValueError(f"pixel count {p} out of range")
    if len(scene_tables) != 11:
        raise ValueError("scene_tables must hold 11 tables")
    s = scene_tables[0].shape[0]
    extra = tuple(t for t in (plane7, emission) if t is not None)
    for t in (*scene_tables, sky6, cam19, *extra):
        if t.device != dev:
            raise ValueError(f"all inputs must lie on {dev}, got {t.device}")
    for t in scene_tables:
        if t.shape != (s,):
            raise ValueError("scene tables must all be [S]")
    if s == 0:
        raise ValueError("the scene has no spheres")
    if sky6.shape != (6,) or cam19.shape != (19,) or (
        plane7 is not None and plane7.shape != (7,)
    ):
        raise ValueError("sky6, cam19, plane7 must be f32[6], f32[19], f32[7]")
    if emission is not None and emission.shape != (s, 3):
        raise ValueError(f"emission must be [S, 3] = [{s}, 3], got {tuple(emission.shape)}")
    if not 0 < max_depth <= 30 or n_samples < 1:
        raise ValueError("need 0 < max_depth <= 30 and n_samples >= 1")
    groups = sample_groups(n_samples)
    if p * groups >= 2**31:
        raise ValueError(f"{p} pixels x {groups} sample groups: 2^31 work items or more")

    tab = sphere_table(scene_tables)
    s_pad = tab.shape[0]
    check_smem(s_pad, TABLE_SLOT_BYTES)
    f32 = torch.float32
    plane = plane7 if plane7 is not None else torch.zeros(7, dtype=f32, device=dev)
    consts = torch.cat([sky6.to(f32), plane.to(f32), cam19.to(f32)]).contiguous()
    pix = pixel_ids.to(torch.int32).contiguous()
    k0, k1 = key_words(key2)
    emit = emit_table(emission, s_pad)

    out = torch.empty((p, 3), dtype=f32, device=dev)
    cnt = torch.empty((p,), dtype=f32, device=dev) if return_counts else None
    # Each sample group's partial sums, which the combine adds in order.
    part = part_cnt = None
    if groups > 1:
        part = torch.empty((groups, p, 3), dtype=f32, device=dev)
        part_cnt = torch.empty((groups, p), dtype=f32, device=dev) if return_counts else None
    # The kernel's item counter: its lanes fetch positions from it.
    next_pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = load_library()
    # The launch goes to the current device: make it the tensors' device.
    with torch.cuda.device(dev):
        err = lib.lib.spt_persistent_render(
            pix.data_ptr(), p, tab.data_ptr(), s_pad,
            consts.data_ptr(), int(plane7 is not None), k0, k1,
            int(sample_offset) & 0xFFFFFFFF, int(n_samples), SAMPLE_GROUP, groups,
            int(max_depth), int(width), _f32(1.0 / width), _f32(1.0 / height),
            float(t_min), float(t_max), int(rr_start_depth),
            emit.data_ptr() if emit is not None else None, next_pos.data_ptr(),
            part.data_ptr() if part is not None else None,
            part_cnt.data_ptr() if part_cnt is not None else None,
            out.data_ptr(), cnt.data_ptr() if cnt is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"persistent kernel launch failed: CUDA error {err}")
    tracing.count("launch.persistent")
    tracing.count("persistent.items", p * groups)
    if groups > 1:
        tracing.count("launch.persistent.split")
    if emit is not None:
        tracing.count("launch.persistent.emit")
    return (out, cnt) if return_counts else out


def grid_blocks(n_items: int, n_spheres: int) -> int:
    """Blocks of 128 lanes the kernel's resident grid has for ``n_items``
    work items (pixels x ``sample_groups``) over ``n_spheres`` sphere slots
    (padded to a multiple of 4), on the current CUDA device."""
    s_pad = n_spheres + (-n_spheres) % 4
    blocks = ctypes.c_int(0)
    err = load_library().lib.spt_persistent_grid(int(n_items), s_pad, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"persistent kernel grid query failed: CUDA error {err}")
    return blocks.value


# --------------------------------------------------------------------------
# Plain version


_TWO_PI = _f32(2.0 * np.pi)
_THIRD = _f32(1.0 / 3.0)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _scatter_plain(dx, dy, dz, nx, ny, nz, mat, fz, io, u):
    """scatter_tiles in the kernel's formulation, branchless over [N]."""
    two_pi = _TWO_PI
    front = _dot(dx, dy, dz, nx, ny, nz) < 0.0
    fs = torch.where(front, 1.0, -1.0)
    nfx, nfy, nfz = nx * fs, ny * fs, nz * fs
    dn = _dot(dx, dy, dz, nfx, nfy, nfz)
    cos_t = torch.clamp(-dn, max=1.0)

    zl = 1.0 - 2.0 * u[0]
    rl = torch.sqrt(torch.clamp(1.0 - zl * zl, min=0.0))
    phl = two_pi * u[1]
    lam = (nfx + rl * torch.cos(phl), nfy + rl * torch.sin(phl), nfz + zl)

    two_dn = 2.0 * dn
    rf = (dx - two_dn * nfx, dy - two_dn * nfy, dz - two_dn * nfz)
    zm = 1.0 - 2.0 * u[2]
    rm = torch.sqrt(torch.clamp(1.0 - zm * zm, min=0.0))
    phm = two_pi * u[3]
    bscale = torch.exp(torch.log(torch.clamp(u[4], min=1e-30)) * _THIRD) * fz
    met = (rf[0] + bscale * rm * torch.cos(phm),
           rf[1] + bscale * rm * torch.sin(phm),
           rf[2] + bscale * zm)

    eta = torch.where(front, 1.0 / io, io)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    cannot = eta * eta * sin2 > 1.0
    r0s = (1.0 - eta) / (1.0 + eta)
    r0 = r0s * r0s
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    do_refl = cannot | (u[5] < refl_p)
    pp = (eta * (dx + cos_t * nfx), eta * (dy + cos_t * nfy), eta * (dz + cos_t * nfz))
    par = torch.sqrt(torch.clamp(1.0 - _dot(*pp, *pp), min=1e-12))
    die = tuple(
        torch.where(do_refl, rf[i], pp[i] - par * nf)
        for i, nf in enumerate((nfx, nfy, nfz))
    )

    is_metal = mat == int(Material.METAL)
    is_diel = mat == int(Material.DIELECTRIC)
    g = tuple(
        torch.where(is_diel, die[i], torch.where(is_metal, met[i], lam[i]))
        for i in range(3)
    )
    g2 = _dot(*g, *g)
    ginv = torch.rsqrt(torch.clamp(g2, min=1e-20))
    deg = g2 <= 1e-12
    sd = tuple(torch.where(deg, nf, gi * ginv) for gi, nf in zip(g, (nfx, nfy, nfz)))
    scattered = ~is_metal | (_dot(*sd, nfx, nfy, nfz) > 0.0)
    return sd, is_diel, scattered


def camera_ray_plain(cam19, k0, k1, pix, sid, width, height):
    """Thin-lens camera rays (ox, oy, oz, dx, dy, dz) for int64 pixel and
    sample ids: the kernels' camera_ray (slots 124/125) in the same ops."""
    f32 = torch.float32
    c1b = (sid << 8) & 0xFFFFFFFF
    c = cam19.tolist()

    def uniforms(slot):
        w0, w1 = threefry2x32(k0, k1, pix, c1b | slot)
        return _to_unit_float(w0), _to_unit_float(w1)

    xf = (pix % width).to(f32)
    yf = torch.div(pix, width, rounding_mode="floor").to(f32)
    jx, jy = uniforms(124)
    lu, lv = uniforms(125)
    s01 = (xf + jx) * _f32(1.0 / width)
    t01 = 1.0 - (yf + jy) * _f32(1.0 / height)
    lr = torch.sqrt(lu) * c[18]
    th = _TWO_PI * lv
    ou, ov = lr * torch.cos(th), lr * torch.sin(th)
    ox = c[0] + ou * c[12] + ov * c[15]
    oy = c[1] + ou * c[13] + ov * c[16]
    oz = c[2] + ou * c[14] + ov * c[17]
    dx = c[3] + s01 * c[6] + t01 * c[9] - ox
    dy = c[4] + s01 * c[7] + t01 * c[10] - oy
    dz = c[5] + s01 * c[8] + t01 * c[11] - oz
    ninv = torch.rsqrt(_dot(dx, dy, dz, dx, dy, dz) + 1e-20)
    return ox, oy, oz, dx * ninv, dy * ninv, dz * ninv


def closest_hit_plain(ox, oy, oz, dx, dy, dz, cx, cy, cz, rad, t_min, t_max):
    """The kernels' closest_hit over [N] rays and [S] spheres: (t [N],
    index [N] int64, hit [N] bool) -- nearest valid root, first index on
    ties, t_max and index 0 on a miss."""
    ocx = cx[None, :] - ox[:, None]
    ocy = cy[None, :] - oy[:, None]
    ocz = cz[None, :] - oz[:, None]
    tc = ocx * dx[:, None] + ocy * dy[:, None] + ocz * dz[:, None]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    disc = (rad * rad)[None, :] - (oc2 - tc * tc)
    sq = torch.sqrt(disc)
    t_near = tc - sq
    t = torch.where(t_near > t_min, t_near, tc + sq)
    ok = (t > t_min) & (t < t_max)
    t_sel = torch.where(ok, t, torch.full_like(t, t_max))
    bi = torch.argmin(t_sel, dim=1)
    bt = torch.gather(t_sel, 1, bi[:, None])[:, 0]
    return bt, bi, bt < t_max


def _trace_plain(pix, sid, tables, sky6, cam19, plane7, k0, k1, max_depth,
                 width, height, t_min, t_max, rr_start_depth, emission=None):
    """Trace one (pixel, sample) path per entry: ([N, 3] radiance, [N]
    bounce iterations).  With ``emission`` ([S, 3]) every sphere hit adds
    the throughput before the hit's attenuation times the winner's
    emission."""
    f32 = torch.float32
    cx, cy, cz, rad, _r2, ar, ag, ab, mat, fz, io = tables
    c1b = (sid << 8) & 0xFFFFFFFF

    def uniforms(slot):
        w0, w1 = threefry2x32(k0, k1, pix, c1b | slot)
        return _to_unit_float(w0), _to_unit_float(w1)

    ox, oy, oz, dx, dy, dz = camera_ray_plain(cam19, k0, k1, pix, sid, width, height)

    n = pix.shape[0]
    tp = [torch.ones(n, dtype=f32, device=pix.device) for _ in range(3)]
    acc = [torch.zeros(n, dtype=f32, device=pix.device) for _ in range(3)]
    iters = torch.zeros(n, dtype=f32, device=pix.device)
    alive = torch.ones(n, dtype=torch.bool, device=pix.device)
    sky = sky6.tolist()
    for b in range(max_depth):
        iters = iters + alive.to(f32)
        bt, bi, hit = closest_hit_plain(ox, oy, oz, dx, dy, dz, cx, cy, cz, rad, t_min, t_max)
        w = (cx[bi], cy[bi], cz[bi], rad[bi], ar[bi], ag[bi], ab[bi],
             mat[bi].to(torch.int64), fz[bi], io[bi])
        wcx, wcy, wcz, wr, war, wag, wab, wmat, wfz, wio = w
        we = emission[bi] if emission is not None else None
        if plane7 is not None:
            pl = plane7.tolist()
            denom = dx * pl[0] + dy * pl[1] + dz * pl[2]
            num = -(ox * pl[0] + oy * pl[1] + oz * pl[2] + pl[3])
            live = torch.abs(denom) > 1e-8
            tpl = num / torch.where(live, denom, torch.ones_like(denom))
            wins = live & (tpl > t_min) & (tpl < bt)
            sgn = torch.where(denom > 0.0, -1.0, 1.0)
            wcx = torch.where(wins, (ox + tpl * dx) - sgn * pl[0], wcx)
            wcy = torch.where(wins, (oy + tpl * dy) - sgn * pl[1], wcy)
            wcz = torch.where(wins, (oz + tpl * dz) - sgn * pl[2], wcz)
            wr = torch.where(wins, 1.0, wr)
            war = torch.where(wins, pl[4], war)
            wag = torch.where(wins, pl[5], wag)
            wab = torch.where(wins, pl[6], wab)
            wmat = torch.where(wins, int(Material.LAMBERTIAN), wmat)
            wfz = torch.where(wins, 0.0, wfz)
            wio = torch.where(wins, 1.0, wio)
            bt = torch.where(wins, tpl, bt)
            hit = hit | wins
            if we is not None:
                we = torch.where(wins[:, None], 0.0, we)

        miss = alive & ~hit
        h = 0.5 * (dy + 1.0)
        for ch in range(3):
            skc = sky[ch] + (sky[ch + 3] - sky[ch]) * h
            acc[ch] = torch.where(miss, acc[ch] + tp[ch] * skc, acc[ch])
        if we is not None:
            lit = alive & hit
            for ch in range(3):
                acc[ch] = torch.where(lit, acc[ch] + tp[ch] * we[:, ch], acc[ch])

        px, py, pz = ox + bt * dx, oy + bt * dy, oz + bt * dz
        nx, ny, nz = (px - wcx) / wr, (py - wcy) / wr, (pz - wcz) / wr
        inv = torch.rsqrt(_dot(nx, ny, nz, nx, ny, nz) + 1e-20)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        u = []
        for e in range(3):
            u.extend(uniforms(4 * b + e))
        sd, is_diel, scattered = _scatter_plain(
            dx, dy, dz, nx, ny, nz, wmat, wfz, wio, u
        )
        surv = alive & hit & scattered & (b + 1 < max_depth)
        for ch, a in enumerate((war, wag, wab)):
            tp[ch] = torch.where(surv & ~is_diel, tp[ch] * a, tp[ch])
        if rr_start_depth and b >= rr_start_depth:
            q = torch.clamp(torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]), 0.05, 1.0)
            u6, _ = uniforms(4 * b + 3)
            surv = surv & ~(u6 >= q)
            boost = 1.0 / q
            for ch in range(3):
                tp[ch] = torch.where(surv, tp[ch] * boost, tp[ch])
        lf = alive & hit
        ox, oy, oz = (torch.where(lf, pv, ov_) for pv, ov_ in ((px, ox), (py, oy), (pz, oz)))
        dx, dy, dz = (torch.where(surv, sv, dv) for sv, dv in zip(sd, (dx, dy, dz)))
        alive = surv
        if not bool(alive.any()):
            break
    return torch.stack(acc, dim=-1), iters


def render_block_persistent_reference(
    pixel_ids, scene_tables, sky6, cam19, key2, sample_offset,
    n_samples, max_depth, width, height,
    t_min=1e-3, t_max=3.0e7, rr_start_depth=0, return_counts=False,
    plane7=None, emission=None,
):
    """Plain PyTorch version of the persistent kernel: the same sums and
    counts, as a wavefront over all (pixel, sample) pairs in spp chunks.

    As in the kernel, each group of ``SAMPLE_GROUP`` samples
    (``sample_groups``) is summed from 0 in sample order and the groups'
    sums are added from 0 in group order; with one group (or one sample a
    group) that is the plain sequential sum.  The pixels are traced in
    ascending id order and returned in the caller's order, so a permutation
    of ``pixel_ids`` permutes the result bit for bit (the kernel's property
    that lane placement changes no value).
    """
    tracing.count("plain.render_block_persistent_reference")
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    order = torch.argsort(pixel_ids, stable=True)
    pids = pixel_ids[order].to(torch.int64)
    k0, k1 = key_words(key2)
    tables = tuple(scene_tables)
    s = tables[0].shape[0]
    chunk = max(1, min(n_samples, _PLAIN_CHUNK_ELEMS // max(1, p * s)))
    zeros_rad = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    zeros_cnt = torch.zeros((p,), dtype=torch.float32, device=dev)
    rad_sum, cnt = zeros_rad, zeros_cnt          # over the groups
    grp_rad, grp_cnt = zeros_rad, zeros_cnt      # over the open group's samples
    base = int(sample_offset)
    for s0 in range(0, n_samples, chunk):
        c = min(chunk, n_samples - s0)
        pix = pids.repeat(c)
        sid = (base + s0 + torch.arange(c, device=dev)).repeat_interleave(p)
        rad, it = _trace_plain(
            pix, sid, tables, sky6, cam19, plane7, k0, k1, max_depth,
            width, height, t_min, t_max, rr_start_depth, emission,
        )
        rad, it = rad.reshape(c, p, 3), it.reshape(c, p)
        for j in range(c):
            grp_rad = grp_rad + rad[j]
            grp_cnt = grp_cnt + it[j]
            k = s0 + j + 1
            if k % SAMPLE_GROUP == 0 or k == n_samples:
                rad_sum, cnt = rad_sum + grp_rad, cnt + grp_cnt
                grp_rad, grp_cnt = zeros_rad, zeros_cnt
    out = torch.empty_like(rad_sum)
    out[order] = rad_sum
    if return_counts:
        counts = torch.empty_like(cnt)
        counts[order] = cnt
        return out, counts
    return out
