"""Edge cases the port's kernels are held to, shared by the tests and
``chip_smoke.py``: the bucket's key patterns (each takes a path of the
kernel's warp reduction) and the float64 bound its sums keep, and the
grazing rays of the index-and-t closest hit."""

import numpy as np
import torch

PATTERNS = ("one_key", "alternating", "distinct_32", "slot0_90", "no_slot", "zeros", "ragged")


def key_pattern(pattern, n_buckets, k, rng, n):
    """(cols [k, n'] f32, idx [n'] int32) numpy arrays of a key pattern: one
    key over every row, two keys alternating, 32 distinct keys per group of
    32 rows (as many as n_buckets allows), 90% of rows on slot 0, rows that
    name no slot (idx -1 and idx >= n_buckets), zero cotangents, or, for
    "ragged", random keys over n' = n - 3 rows (not a multiple of 32)."""
    if pattern == "ragged":
        n -= 3
    r = np.arange(n)
    if pattern == "one_key":
        idx = np.full(n, rng.integers(n_buckets))
    elif pattern == "alternating":
        idx = np.where(r % 2 == 0, 0, n_buckets - 1)
    elif pattern == "distinct_32":
        idx = (r % 32 + 7 * (r // 32)) % n_buckets
    elif pattern == "slot0_90":
        idx = np.where(rng.uniform(size=n) < 0.9, 0, rng.integers(0, n_buckets, n))
    elif pattern == "no_slot":
        idx = rng.integers(-1, n_buckets + 3, n)
        idx[rng.uniform(size=n) < 0.3] = -1
        idx[rng.uniform(size=n) < 0.1] = n_buckets + 1000
    else:
        idx = rng.integers(0, n_buckets, n)
    cols = rng.normal(size=(k, n)) * 10.0 ** rng.uniform(-3, 1, (k, 1))
    if pattern == "zeros":
        cols[rng.uniform(size=(k, n)) < 0.5] = 0.0
        cols[0] = 0.0
    return cols.astype(np.float32), idx.astype(np.int32)


def float64_bound(cols, idx, n_buckets):
    """(float64 [n_buckets, K] sums of the rows of ``cols`` [K, R] whose
    ``idx`` [R] names a slot, each entry's bound) on the device of ``cols``.
    The bucket's atomics add in an order that changes from run to run, so a
    float32 sum is held to the float64 one within rtol 1e-5, atol 1e-7 of
    max |cols|, and 8 float32 roundings of the entry's absolute row sum."""
    flat = idx.reshape(-1).long()
    keep = (flat >= 0) & (flat < n_buckets)
    src = cols.reshape(cols.shape[0], -1)[:, keep].T.double()
    ref = torch.zeros((n_buckets, cols.shape[0]), dtype=torch.float64, device=cols.device)
    mag = ref.clone().index_add_(0, flat[keep], src.abs())
    ref.index_add_(0, flat[keep], src)
    tol = 1e-5 * ref.abs() + 1e-7 * cols.abs().max().double() + 8 * 2.0 ** -23 * mag
    return ref, tol


# Spheres centered on the z axis ([S, 3] centers, [S] radii), where the
# grazing rays' tangency is exact.
AXIS_SPHERES = ([[0.0, 0.0, 5.0], [0.0, 0.0, 9.0], [0.0, 0.0, 14.0], [0.0, 0.0, 20.0]],
                [1.0, 2.0, 0.5, 3.0])


def grazing_rays(centers, radii, t_min=1e-3):
    """Rays at the edge cases of the index-and-t closest hit's test: ([N, 3]
    origins, [N, 3] unit directions) f32 on the spheres' device, 19 per
    sphere.  For each sphere, rays along +z that start r short of its
    center's plane, offset from the center by r in x or y (tangent: disc is
    0 where the arithmetic is exact, as for a center on the z axis and r =
    1), and by the floats just above and below r (a miss and a hit by an
    ulp where it is exact); rays from its center (along x, -x and z) and
    from half a radius off it; and rays along +z that start r + eps short of
    its center, so the near root is eps, at 0.5, 1 and 2 times ``t_min``."""
    with torch.no_grad():
        c = centers.detach().to(torch.float32)
        r = radii.detach().to(torch.float32).abs()
        ez = c.new_tensor([0.0, 0.0, 1.0]).expand_as(c)
        back = r[:, None] * ez
        up = torch.nextafter(r, torch.full_like(r, torch.inf))
        down = torch.nextafter(r, torch.zeros_like(r))
        origins, dirs = [], []
        for off in (r, up, down):
            for axis, sign in ((0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0)):
                shift = torch.zeros_like(c)
                shift[:, axis] = sign * off
                origins.append(c + shift - back)
                dirs.append(ez)
        for d in ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0)):
            origins.append(c)
            dirs.append(c.new_tensor(d).expand_as(c))
        half = torch.zeros_like(c)
        half[:, 0] = 0.5 * r
        origins.append(c + half)
        dirs.append(ez)
        for eps in (0.5 * t_min, t_min, 2.0 * t_min):
            origins.append(c - (r + eps)[:, None] * ez)
            dirs.append(ez)
        return torch.cat(origins).contiguous(), torch.cat(dirs).contiguous()
