"""threefry2x32 keys and streams (frozen copy of the path tracer's sampler).

Every random number is a pure function of (key, pixel id, sample id, slot):
``threefry2x32(key, counter=(pixel_id, sample_id << 8 | slot))``.  Slots:
bounce b uses 4b .. 4b+3 (8 uniforms), the camera 124 and 125, the soft
scan's crossing and validity coins 128 + b.  Words are held in int64 and
masked to 32 bits after every add and shift.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry2x32 (Salmon et al., SC'11) on int64 tensors or ints
    holding u32 values; returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64) & M32
    k1 = torch.as_tensor(k1, dtype=torch.int64) & M32
    c0 = torch.as_tensor(c0, dtype=torch.int64) & M32
    c1 = torch.as_tensor(c1, dtype=torch.int64) & M32
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32

    def four(x0, x1, rs):
        for r in rs:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + k1) & M32, (x1 + ks2 + 1) & M32
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = (x0 + ks2) & M32, (x1 + k0 + 2) & M32
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + k0) & M32, (x1 + k1 + 3) & M32
    x0, x1 = four(x0, x1, _ROT[4:])
    x0, x1 = (x0 + k1) & M32, (x1 + ks2 + 4) & M32
    x0, x1 = four(x0, x1, _ROT[:4])
    x0, x1 = (x0 + ks2) & M32, (x1 + k0 + 5) & M32
    return x0, x1


def key_from_seed(seed: int) -> tuple[int, int]:
    """The run's key: the seed's high and low 32-bit words, so every seed
    below 2^64 gives its own key."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return (seed >> 32) & M32, seed & M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """A new key from ``key`` and ``data``: the cipher applied to the
    counter (0, data mod 2^32), as jax.random.fold_in does for a raw
    threefry key."""
    w0, w1 = threefry2x32(key[0], key[1], 0, int(data) & M32)
    return int(w0), int(w1)


def unit(bits, dtype=torch.float32):
    """u32 word -> [0, 1) from its top 24 bits."""
    return (bits >> 8).to(dtype) * (2.0 ** -24)


def uniforms(key, pix, samp, slot: int, dtype=torch.float32):
    """The two uniforms of ``slot`` for int64 pixel and sample ids."""
    c1 = ((samp << 8) & M32) | slot
    w0, w1 = threefry2x32(key[0], key[1], pix, c1)
    return unit(w0, dtype), unit(w1, dtype)


def bounce_uniforms(key, pix, samp, b: int, dtype=torch.float32, n_evals: int = 4):
    """The first 2 * ``n_evals`` of bounce ``b``'s 8 uniforms: 0-1
    Lambertian, 2-4 metal fuzz ball, 5 dielectric coin, 6 Russian roulette,
    7 soft acceptance coin."""
    u = []
    for e in range(n_evals):
        u.extend(uniforms(key, pix, samp, 4 * b + e, dtype))
    return tuple(u)
