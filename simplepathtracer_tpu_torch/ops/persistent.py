"""Persistent whole-render kernel: host side, wrapper and plain version.

Counterpart of the JAX package's ``ops/pallas_persistent.py`` (and the host
side of ``ops/pallas_common.py``).  ``render_block_persistent`` returns, for
each pixel id, the radiance SUM over ``n_samples`` consecutive sample ids
and optionally the number of bounce iterations those samples executed (the
cost signal of the lane balancer).

On a CUDA tensor it launches the hand-written kernel in
``csrc/persistent.cu``; on a CPU tensor it calls the plain PyTorch version
``render_block_persistent_reference``, which computes the same function in
the kernel's formulation (direct |oc|^2, camera rays from the f32[19]
block, exp(log(u)/3) cube root), so that the two differ by rounding only.

The kernel is built from the sources in ``csrc/`` at first use
(``ops/cuda_build.py``: nvcc for sm_90a, a plain C interface, ctypes).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..types import Material
from .cuda_build import load_library
from .sampling import _f32, key_words, threefry2x32, _to_unit_float

# Lanes are laid out in blocks of this many positions: fewer pixels than one
# block give a single bank (the JAX package's (8, 128) tile, kept so that the
# position -> (bank, lane) map and _balanced_perm match it).
BLOCK = 1024
# Pixel banks per lane of the balancer's layout (render._balanced_perm); the
# kernel fetches positions from a counter and reads no bank layout.
GPU_BANKS = 1

# Shared memory one block may use on an H100 (227 KB).
_MAX_SMEM = 232448
_SMEM_PER_SPHERE = 40   # float4 + float4 + float2
# (pixel, sample) rays x spheres per plain-version chunk.
_PLAIN_CHUNK_ELEMS = 1 << 24


def bank_geometry(p: int, n_banks: int) -> tuple[int, int]:
    """(n_banks, n_lanes) of the banked layout for ``p`` positions: lane l
    serves positions l + k * n_lanes for k < n_banks (positions >= p are
    masked).  Same map as the JAX package's ``banked_lane_layout``."""
    n_banks = int(min(n_banks, max(1, p // BLOCK)))
    return n_banks, -(-p // n_banks)


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
    plane7=None,
):
    """Radiance SUM over ``n_samples`` samples for each pixel id: [P, 3] f32,
    and with ``return_counts`` also [P] f32 bounce iterations per pixel.

    pixel_ids: [P] int — global pixel ids (y * width + x).
    scene_tables: 11 [S] tensors (cx, cy, cz, radius, radius^2, albedo rgb,
    material, fuzz, ior); sky6: f32[6]; cam19: f32[19] (camera_constants);
    key2: two u32 words; plane7: f32[7] or None.

    On a CPU tensor this is the plain version.  On a CUDA tensor it
    launches the kernel, or raises.
    """
    if pixel_ids.device.type == "cpu":
        return render_block_persistent_reference(
            pixel_ids, scene_tables, sky6, cam19, key2, sample_offset,
            n_samples, max_depth, width, height, t_min=t_min, t_max=t_max,
            rr_start_depth=rr_start_depth, return_counts=return_counts,
            plane7=plane7,
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
    for t in (*scene_tables, sky6, cam19) + ((plane7,) if plane7 is not None else ()):
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
    if not 0 < max_depth <= 30 or n_samples < 1:
        raise ValueError("need 0 < max_depth <= 30 and n_samples >= 1")

    tables = pad_scene_tables(scene_tables)
    cx, cy, cz, rad, _r2, ar, ag, ab, mat, fz, io = tables
    s_pad = cx.shape[0]
    if s_pad * _SMEM_PER_SPHERE > _MAX_SMEM:
        raise ValueError(
            f"{s_pad} spheres need {s_pad * _SMEM_PER_SPHERE} B of shared "
            f"memory; a block has {_MAX_SMEM} B"
        )
    f32 = torch.float32
    tab = torch.stack(
        [cx, cy, cz, rad, ar, ag, ab, fz, io, mat.to(f32)], dim=1
    ).to(f32).contiguous()
    plane = plane7 if plane7 is not None else torch.zeros(7, dtype=f32, device=dev)
    consts = torch.cat([sky6.to(f32), plane.to(f32), cam19.to(f32)]).contiguous()
    pix = pixel_ids.to(torch.int32).contiguous()
    k0, k1 = key_words(key2)

    out = torch.empty((p, 3), dtype=f32, device=dev)
    cnt = torch.empty((p,), dtype=f32, device=dev) if return_counts else None
    # The kernel's pixel counter: its lanes fetch positions from it.
    next_pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = load_library()
    # The launch goes to the current device: make it the tensors' device.
    with torch.cuda.device(dev):
        err = lib.lib.spt_persistent_render(
            pix.data_ptr(), p, tab.data_ptr(), s_pad,
            consts.data_ptr(), int(plane7 is not None), k0, k1,
            int(sample_offset) & 0xFFFFFFFF, int(n_samples), int(max_depth),
            int(width), _f32(1.0 / width), _f32(1.0 / height),
            float(t_min), float(t_max), int(rr_start_depth), next_pos.data_ptr(),
            out.data_ptr(), cnt.data_ptr() if cnt is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"persistent kernel launch failed: CUDA error {err}")
    render_block_persistent.launches += 1
    return (out, cnt) if return_counts else out


render_block_persistent.launches = 0


def grid_blocks(n_pix: int, n_spheres: int) -> int:
    """Blocks of 128 lanes the kernel's resident grid has for ``n_pix``
    pixels over ``n_spheres`` sphere slots (padded to a multiple of 4), on
    the current CUDA device."""
    s_pad = n_spheres + (-n_spheres) % 4
    blocks = ctypes.c_int(0)
    err = load_library().lib.spt_persistent_grid(int(n_pix), s_pad, ctypes.addressof(blocks))
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
                 width, height, t_min, t_max, rr_start_depth):
    """Trace one (pixel, sample) path per entry: ([N, 3] radiance, [N]
    bounce iterations)."""
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

        miss = alive & ~hit
        h = 0.5 * (dy + 1.0)
        for ch in range(3):
            skc = sky[ch] + (sky[ch + 3] - sky[ch]) * h
            acc[ch] = torch.where(miss, acc[ch] + tp[ch] * skc, acc[ch])

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
    plane7=None,
):
    """Plain PyTorch version of the persistent kernel: the same sums and
    counts, as a wavefront over all (pixel, sample) pairs in spp chunks.

    Each pixel's samples are summed in sample order, as in the kernel.  The
    pixels are traced in ascending id order and returned in the caller's
    order, so a permutation of ``pixel_ids`` permutes the result bit for bit
    (the kernel's property that lane placement changes no value).
    """
    render_block_persistent_reference.calls += 1
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    order = torch.argsort(pixel_ids, stable=True)
    pids = pixel_ids[order].to(torch.int64)
    k0, k1 = key_words(key2)
    tables = tuple(scene_tables)
    s = tables[0].shape[0]
    chunk = max(1, min(n_samples, _PLAIN_CHUNK_ELEMS // max(1, p * s)))
    rad_sum = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((p,), dtype=torch.float32, device=dev)
    base = int(sample_offset)
    for s0 in range(0, n_samples, chunk):
        c = min(chunk, n_samples - s0)
        pix = pids.repeat(c)
        sid = (base + s0 + torch.arange(c, device=dev)).repeat_interleave(p)
        rad, it = _trace_plain(
            pix, sid, tables, sky6, cam19, plane7, k0, k1, max_depth,
            width, height, t_min, t_max, rr_start_depth,
        )
        rad, it = rad.reshape(c, p, 3), it.reshape(c, p)
        for j in range(c):
            rad_sum = rad_sum + rad[j]
            cnt = cnt + it[j]
    out = torch.empty_like(rad_sum)
    out[order] = rad_sum
    if return_counts:
        counts = torch.empty_like(cnt)
        counts[order] = cnt
        return out, counts
    return out


render_block_persistent_reference.calls = 0
