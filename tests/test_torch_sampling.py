"""The port's counter-based RNG against the JAX package's, bit for bit.

The two packages must draw the same words from the same key and global
(pixel, sample) ids, so that they render the same image from the same
scene tables.  Inputs are made with numpy and handed to both.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from simplepathtracer_tpu.ops import sampling as js
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import sampling as ts


def test_threefry2x32_bit_exact():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = rng.integers(0, 2**32, size=(4, 4096), dtype=np.uint64).astype(np.uint32)
    # Edge words: all zeros and all ones.
    k0[:2], k1[:2], c0[:2], c1[:2] = (0, 2**32 - 1), (0, 2**32 - 1), (0, 2**32 - 1), (0, 2**32 - 1)
    w0, w1 = js.threefry2x32(*(jnp.asarray(x) for x in (k0, k1, c0, c1)))
    t0, t1 = ts.threefry2x32(*(torch.from_numpy(x.astype(np.int64)) for x in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(w0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(w1).astype(np.int64))


def _contexts(seed):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 1200 * 800, 512)
    smp = rng.integers(0, 5000, 512)
    jctx = js.ray_keys(jax.random.PRNGKey(seed), jnp.asarray(pix), jnp.asarray(smp))
    tctx = ts.ray_keys(ts.make_key(seed), torch.from_numpy(pix), torch.from_numpy(smp))
    return jctx, tctx


@pytest.mark.parametrize("bounce", [0, 1, 9, 29])
def test_bounce_noise_exact(bounce):
    jctx, tctx = _contexts(3)
    np.testing.assert_array_equal(
        ts.bounce_noise(tctx, bounce).numpy(), np.asarray(js.bounce_noise(jctx, bounce))
    )


def test_camera_jitter_exact():
    jctx, tctx = _contexts(4)
    np.testing.assert_array_equal(
        ts.camera_jitter(tctx).numpy(), np.asarray(js.camera_jitter(jctx))
    )


# (key words, pixel ids, sample ids) of the camera-jitter cases: random ids;
# ids at their edges (the cover frame's last pixel, the last sample id a
# counter holds, 2^24 - 1); key words with their high bits set.
_JITTER_CASES = {
    "random": ((0, 4), np.arange(0, 1200 * 800, 1877), np.arange(512) * 37 % 5000),
    "edge_ids": ((0, 9), np.array([0, 1, 1200 * 800 - 2, 1200 * 800 - 1, 48 * 24 - 1, 0]),
                 np.array([0, 2**24 - 1, 2**24 - 1, 2**24 - 2, 7, 2**24 - 1])),
    "high_key_bits": ((0xFFFFFFFF, 0x80000001), np.arange(1021), np.arange(1021) % 3 + 2**23),
}


@pytest.mark.parametrize("case", sorted(_JITTER_CASES))
def test_camera_jitter_on_cpu_ids_takes_plain_version(case):
    """On CPU ids ``camera_jitter`` runs its plain version once, launches
    nothing, and draws the JAX package's words."""
    (k0, k1), pix, smp = _JITTER_CASES[case]
    words = np.array([k0, k1], dtype=np.uint32)
    jctx = js.ray_keys(jnp.asarray(words), jnp.asarray(pix), jnp.asarray(smp))
    tctx = ts.ray_keys(torch.from_numpy(words.astype(np.int64)), torch.from_numpy(pix),
                       torch.from_numpy(smp))
    before = tracing.counts()
    got = ts.camera_jitter(tctx)
    ran = tracing.counts() - before
    assert ran == Counter({"plain.camera_jitter_reference": 1})
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.camera_jitter(jctx)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 + 5])
def test_make_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(ts.make_key(seed).numpy(), want.astype(np.int64))
    assert ts.key_words(want) == ts.key_words(ts.make_key(seed))


def test_direction_samplers_match():
    rng = np.random.default_rng(5)
    u = rng.random((3, 1000), dtype=np.float32)
    np.testing.assert_allclose(
        ts.unit_sphere_surface(torch.from_numpy(u[0]), torch.from_numpy(u[1])).numpy(),
        np.asarray(js.unit_sphere_surface(jnp.asarray(u[0]), jnp.asarray(u[1]))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        ts.in_unit_ball(*(torch.from_numpy(x) for x in u)).numpy(),
        np.asarray(js.in_unit_ball(*(jnp.asarray(x) for x in u))),
        atol=1e-6,
    )
