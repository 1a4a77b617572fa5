"""Closest-hit kernels on explicit rays: host side, wrappers and plain
versions.

Counterpart of the JAX package's ``ops/pallas_intersect.py`` (named
``closest_hit`` here: ``ops/intersect.py`` is the port's counterpart of
the JAX ``ops/intersect.py``).  Kernels (``csrc/closest_hit.cu``) and their
plain versions, each wrapper taking its plain version for a CPU tensor
only:

* ``closest_hit`` / ``closest_hit_reference`` -- ``closest_hit_pallas``
  (``_closest_hit_kernel``): winner index and t, in that kernel's own
  formulation (r^2 from ``radii * radii``, ``sqrt(max(disc, 0))``, an
  explicit ``disc > 0`` test; the kernel takes the roots only where disc > 0,
  which changes no bit).  ``intersect.intersect_scene_pallas`` rebuilds the
  differentiable hit from the index.
* ``closest_hit_attrs`` / ``closest_hit_attrs_reference`` --
  ``closest_hit_attrs_pallas`` (``_closest_hit_attrs_kernel``): winner index,
  its 9 float attributes (cx cy cz r albedo rgb fuzz ior) and its material,
  over the forward kernels' shared scan (``common.cuh:closest_hit``: NaN
  rejects, disc == 0 is accepted).  The ``use_pallas_hits`` bounce of
  ``render.trace_rays`` reattaches table gradients to the attributes with
  ``table_gather.attach_attr_columns``.

Both are detached.  Rays are [N, 3] origins and directions and an [N] bool
alive mask.  A dead ray skips its scan and gets the miss values (index -1,
t = t_max; centers 0, r 1, albedo 0, material 0, fuzz 0, ior 1).  The JAX
kernels skip only whole 1024-ray blocks without a live ray, so their output
for a dead ray depends on its block and is not part of the contract; live
rays get the same answer either way.
"""

from __future__ import annotations

import torch

from .. import tracing
from .cuda_build import MAX_RAYS, load_library, on_cpu, stream
from .persistent import TABLE_SLOT_BYTES, check_smem, closest_hit_plain, sphere_table

# Shared memory per sphere of the index-and-t kernel: float4 (cx, cy, cz, r^2).
_SMEM_PER_SPHERE_T = 16
# The attributes of a miss (cx cy cz r albedo rgb fuzz ior) and its material.
MISS_ATTRS = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def _rays(origins, dirs, alive):
    """Contiguous f32 [N, 3] rays and a bool [N] mask on one device; raises
    on anything else."""
    n = origins.shape[0]
    if origins.shape != (n, 3) or dirs.shape != (n, 3) or alive.shape != (n,):
        raise ValueError("origins and dirs must be [N, 3], alive [N]")
    if not 0 < n < MAX_RAYS:
        raise ValueError(f"ray count {n} out of range")
    dev = origins.device
    if dirs.device != dev or alive.device != dev:
        raise ValueError(f"all inputs must lie on {dev}")
    if origins.dtype != torch.float32 or dirs.dtype != torch.float32 or alive.dtype != torch.bool:
        raise ValueError("origins and dirs must be float32, alive bool")
    return origins.contiguous(), dirs.contiguous(), alive.contiguous()


# --------------------------------------------------------------------------
# Wrappers


def closest_hit(origins, dirs, alive, centers, radii, t_min=1e-3, t_max=3.0e7):
    """(idx [N] int32, -1 on a miss; t [N] f32, t_max on a miss) of the
    closest sphere in the JAX ``_closest_hit_kernel``'s formulation
    (detached).  ``centers`` [S, 3], ``radii`` [S]: only r^2 matters."""
    if on_cpu(origins):
        return closest_hit_reference(origins, dirs, alive, centers, radii, t_min, t_max)
    o, d, al = _rays(origins.detach(), dirs.detach(), alive)
    dev = o.device
    s = centers.shape[0]
    if centers.shape != (s, 3) or radii.shape != (s,) or centers.device != dev or (
        radii.device != dev
    ):
        raise ValueError(f"centers [S, 3] and radii [S] must lie on {dev}")
    check_smem(s, _SMEM_PER_SPHERE_T)
    with torch.no_grad():
        r = radii.detach().to(torch.float32)
        spheres = torch.cat([centers.detach().to(torch.float32), (r * r)[:, None]], 1).contiguous()
    n = o.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_closest_hit(
            n, spheres.data_ptr(), s, o.data_ptr(), d.data_ptr(), al.data_ptr(),
            float(t_min), float(t_max), idx.data_ptr(), t.data_ptr(), stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"closest-hit kernel launch failed: CUDA error {err}")
    tracing.count("launch.closest_hit")
    return idx, t


def closest_hit_attrs(origins, dirs, alive, tables, t_min=1e-3, t_max=3.0e7, *, tab=None):
    """(idx [N] int32, -1 on a miss; attr9, a tuple of 9 [N] f32 columns
    cx cy cz r albedo rgb fuzz ior; material [N] int32) of the closest
    sphere, over the forward kernels' scan (detached).  ``tables``: the 11
    [S] tables (cx cy cz r r^2 albedo rgb material fuzz ior); ``tab``:
    ``sphere_table(tables)`` where the caller has built it already (a trace
    builds it once for all its bounces)."""
    if on_cpu(origins):
        return closest_hit_attrs_reference(origins, dirs, alive, tables, t_min, t_max, tab=tab)
    o, d, al = _rays(origins.detach(), dirs.detach(), alive)
    dev = o.device
    if len(tables) != 11 or any(t.device != dev for t in tables):
        raise ValueError(f"tables must be the 11 sphere tables on {dev}")
    if tab is None:
        tab = sphere_table(tables)
    elif tab.device != dev or tab.dtype != torch.float32 or tab.dim() != 2 or (
        tab.shape[1] != 10 or not tab.is_contiguous()
    ):
        raise ValueError(f"tab must be a contiguous f32 [S_pad, 10] sphere table on {dev}")
    s_pad = tab.shape[0]
    check_smem(s_pad, TABLE_SLOT_BYTES)
    n = o.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    attr = torch.empty((9, n), dtype=torch.float32, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.lib.spt_closest_hit_attrs(
            n, tab.data_ptr(), s_pad, o.data_ptr(), d.data_ptr(), al.data_ptr(),
            float(t_min), float(t_max), idx.data_ptr(), attr.data_ptr(), mat.data_ptr(),
            stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"closest-hit-attributes kernel launch failed: CUDA error {err}")
    tracing.count("launch.closest_hit_attrs")
    return idx, tuple(attr.unbind(0)), mat


# --------------------------------------------------------------------------
# Plain versions


def sphere_attrs_plain(tab, idx):
    """The kernels' ``sphere_attrs``: the attributes [9, N] and material [N]
    int32 of the rows ``idx`` [N] of the [S_pad, 10] table, the miss values
    where idx names no row (a miss, or a ground-plane code past the table)."""
    s_pad = tab.shape[0]
    rows = tab[torch.clamp(idx, 0, s_pad - 1).to(torch.int64)]
    miss = tab.new_tensor(MISS_ATTRS + (0.0,))
    vals = torch.where(((idx >= 0) & (idx < s_pad))[:, None], rows, miss).T.contiguous()
    return vals[:9], vals[9].to(torch.int32)


def closest_hit_reference(origins, dirs, alive, centers, radii, t_min=1e-3, t_max=3.0e7):
    """Plain version of ``closest_hit``: the [N, S] scan, nearest valid
    root (disc > 0, t > t_min, t < t_max), first index on ties."""
    tracing.count("plain.closest_hit_reference")
    with torch.no_grad():
        o, d = origins.detach(), dirs.detach()
        c = centers.detach()
        r2 = radii.detach() * radii.detach()
        ocx = c[None, :, 0] - o[:, 0:1]
        ocy = c[None, :, 1] - o[:, 1:2]
        ocz = c[None, :, 2] - o[:, 2:3]
        tc = ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3]
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        disc = r2[None, :] - (oc2 - tc * tc)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_near = tc - sq
        t = torch.where(t_near > t_min, t_near, tc + sq)
        ok = (disc > 0.0) & (t > t_min) & (t < t_max)
        t_sel = torch.where(ok, t, torch.full_like(t, t_max))
        bi = torch.argmin(t_sel, dim=1)
        bt = torch.gather(t_sel, 1, bi[:, None])[:, 0]
        hit = alive & (bt < t_max)
        idx = torch.where(hit, bi, -1).to(torch.int32)
        return idx, torch.where(hit, bt, torch.full_like(bt, t_max))


def closest_hit_attrs_reference(origins, dirs, alive, tables, t_min=1e-3, t_max=3.0e7, *,
                                tab=None):
    """Plain version of ``closest_hit_attrs``: ``persistent.closest_hit_plain``
    (the kernels' scan) and the winner's row of the table."""
    tracing.count("plain.closest_hit_attrs_reference")
    with torch.no_grad():
        if tab is None:
            tab = sphere_table(tables)
        o, d = origins.detach(), dirs.detach()
        _, bi, hit = closest_hit_plain(
            o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
            tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 3], t_min, t_max,
        )
        idx = torch.where(alive & hit, bi, -1).to(torch.int32)
        attr, mat = sphere_attrs_plain(tab, idx)
        return idx, tuple(attr.unbind(0)), mat
