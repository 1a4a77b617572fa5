"""Stateless, counter-based sampling (counterpart of the JAX package's
``ops/sampling.py``).

Every random number is a pure function of (key, pixel id, sample id, slot):

    bits = threefry2x32(key, counter = (pixel_id, sample_id << 8 | slot))

so the image does not depend on how pixels and samples are split over
threads, blocks or devices, and the two packages draw the same words.

Slot map (each slot = one threefry eval = 2 words):
    bounce b, eval e in 0..3  ->  slot b*4 + e   (depth <= 30)
    camera jitter             ->  slots 124, 125

PyTorch on the CPU has no uint32 add or shift, and ``int32 >>`` is an
arithmetic shift, so the words are computed in int64 and masked to 32 bits
after every add and shift.  A key is two u32 words held in an int64 [2]
tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# threefry2x32 rotation schedule (Salmon et al., SC'11; same as jax's PRNG).
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def make_key(seed: int) -> torch.Tensor:
    """Two u32 words of a render key: the words ``jax.random.key_data(
    jax.random.PRNGKey(seed))`` holds (JAX without x64 keeps the low 32
    bits of the seed).  Returned as an int64 [2] tensor on the CPU."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """A new key from ``key`` and the integer ``data``: the words
    ``jax.random.fold_in`` gives for a raw threefry key (the cipher applied
    to the counter (0, data mod 2^32)).  Returned as an int64 [2] tensor on
    the CPU, like ``make_key``."""
    k0, k1 = key_words(key)
    w0, w1 = threefry2x32(k0, k1, 0, int(data) & _M32)
    return torch.tensor([int(w0), int(w1)], dtype=torch.int64)


def key_words(key) -> tuple[int, int]:
    """(k0, k1) as Python ints from a key tensor or array of two words."""
    kd = key.tolist() if isinstance(key, torch.Tensor) else np.asarray(key).tolist()
    if len(kd) != 2:
        raise ValueError(f"a key holds two u32 words, got {kd!r}")
    return int(kd[0]) & _M32, int(kd[1]) & _M32


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry2x32 on int64 tensors holding u32 values.

    Returns two int64 tensors with the u32 output words.  Bit-identical to
    the JAX package's ``ops.sampling.threefry2x32``.
    """
    k0 = torch.as_tensor(k0, dtype=torch.int64) & _M32
    k1 = torch.as_tensor(k1, dtype=torch.int64) & _M32
    c0 = torch.as_tensor(c0, dtype=torch.int64) & _M32
    c1 = torch.as_tensor(c1, dtype=torch.int64) & _M32
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32

    def four(x0, x1, rs):
        for r in rs:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + k1) & _M32, (x1 + ks2 + 1) & _M32
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = (x0 + ks2) & _M32, (x1 + k0 + 2) & _M32
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + k0) & _M32, (x1 + k1 + 3) & _M32
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = (x0 + k1) & _M32, (x1 + ks2 + 4) & _M32
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + ks2) & _M32, (x1 + k0 + 5) & _M32
    return x0, x1


def _to_unit_float(bits):
    """u32 word -> f32 in [0, 1) from its top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * np.float32(2.0**-24)


class RayCtx(NamedTuple):
    """Per-ray RNG context: cipher key + global (pixel, sample) counters."""

    k0: int
    k1: int
    pixel: torch.Tensor   # [N] i64 — global pixel id
    sample: torch.Tensor  # [N] i64 — global sample id (< 2^24)


def ray_keys(key, pixel_ids, sample_ids) -> RayCtx:
    """Build the per-ray RNG context from global (pixel, sample) ids."""
    k0, k1 = key_words(key)
    pixel_ids, sample_ids = torch.broadcast_tensors(
        torch.as_tensor(pixel_ids), torch.as_tensor(sample_ids)
    )
    return RayCtx(
        k0=k0, k1=k1,
        pixel=pixel_ids.to(torch.int64) & _M32,
        sample=sample_ids.to(torch.int64) & _M32,
    )


def _uniform_words(ctx: RayCtx, slot0: int, n_evals: int):
    """n_evals threefry evals -> 2*n_evals uniform [N] f32 columns."""
    c1_base = (ctx.sample << 8) & _M32
    cols = []
    for e in range(n_evals):
        w0, w1 = threefry2x32(ctx.k0, ctx.k1, ctx.pixel, c1_base | (slot0 + e))
        cols.append(_to_unit_float(w0))
        cols.append(_to_unit_float(w1))
    return cols


def bounce_noise(ctx: RayCtx, bounce: int) -> torch.Tensor:
    """All randomness one bounce needs, per ray: uniforms [N, 8].

    Columns: 0-1 Lambertian (z, phi); 2-4 metal fuzz ball (z, phi, r);
    5 dielectric reflect coin; 6 Russian roulette; 7 unused here (the soft
    silhouette coin of the JAX package).
    """
    return torch.stack(_uniform_words(ctx, int(bounce) * 4, 4), dim=-1)


def camera_jitter(ctx: RayCtx) -> torch.Tensor:
    """Per-ray (2 pixel-jitter, 2 lens-disk) uniforms [N, 4]."""
    return torch.stack(_uniform_words(ctx, 124, 2), dim=-1)


def unit_sphere_surface(u_z, u_phi):
    """Uniform directions on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u_z
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = np.float32(2.0 * np.pi) * u_phi
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_ball(u_z, u_phi, u_r):
    """Uniform points inside the unit ball: surface point scaled by U^(1/3)."""
    return unit_sphere_surface(u_z, u_phi) * torch.pow(u_r, 1.0 / 3.0)[..., None]
