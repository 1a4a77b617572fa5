"""The soft-silhouette sampling and geometry of the port against the JAX
package: ``crossing_noise``, the band scales, ``grad_capped_sqrt``,
``silhouette_logit`` and ``intersect_scene_soft``.

Inputs are made from a seed with numpy and handed to both packages.

Bounds, and why:

* ``crossing_noise``: bit for bit (integer threefry words, exact 24-bit
  floats);
* the scales: float32 ops in the same order, so equal;
* the capped sqrt: value within one float32 ulp (XLA's CPU sqrt is not
  always correctly rounded), gradient 1e-6 relative;
* ``silhouette_logit``: within 2 float32 ulps of |log u| + |log(1 - u)|,
  the size of the two terms it subtracts (XLA's and PyTorch's CPU ``log``
  are different polynomials);
* ``intersect_scene_soft`` on 4,096 random rays with random coins and a
  random previous winner: winner, hit and blocker equal except on knife
  edges -- a coin or a front-blocker test decided by the last bit of a
  discriminant, which the matmul form sums in another order in the two
  packages -- on at most 0.5% of rays (the repo's knife-edge share,
  ``tests/test_pallas_bounce.py:44-46``); on the other rays the hit t and
  normal 1e-4 (the matmul form's |c|^2 - 2 o.c + |o|^2 cancels terms of
  ~1e6 on the r=1000 ground sphere, summed in another order by XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.ops import intersect as ji, sampling as js
from simplepathtracer_tpu.scenes import compact_scene

from simplepathtracer_tpu_torch.convert import convert_scene
from simplepathtracer_tpu_torch.ops import intersect as ti, sampling as ts

SOFT = 0.05


def test_crossing_noise_matches_jax():
    rng = np.random.default_rng(0)
    n = 4096
    pix = rng.integers(0, 2**31, n).astype(np.int64)
    samp = rng.integers(0, 2**24, n).astype(np.int64)
    key = jax.random.PRNGKey(17)
    jctx = js.ray_keys(key, jnp.asarray(pix, jnp.uint32), jnp.asarray(samp, jnp.uint32))
    tctx = ts.ray_keys(torch.tensor(np.asarray(key).astype(np.int64)),
                       torch.tensor(pix), torch.tensor(samp))
    for b in (0, 1, 7, 29):
        jx, jv = js.crossing_noise(jctx, b)
        tx, tv = ts.crossing_noise(tctx, b)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        # Slot 128 + b: not a bounce or camera slot's words.
        assert not np.array_equal(tx.numpy(), ts.bounce_noise(tctx, b)[:, 0].numpy())


def test_soft_scales_match_jax():
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.uniform(-3, 3, 2000), [1000.0, 100.0, -0.5, 0.2]]).astype(np.float32)
    for soft in (0.02, 0.05):
        for jf, tf in ((ji.silhouette_scale, ti.silhouette_scale),
                       (ji.crossing_scale, ti.crossing_scale),
                       (ji.validity_scale, ti.validity_scale)):
            np.testing.assert_array_equal(tf(soft, torch.tensor(r)).numpy(),
                                          np.asarray(jf(soft, jnp.asarray(r))))
    dmax = rng.uniform(1e-12, 4.0, 2000).astype(np.float32)
    scale = rng.uniform(1e-4, 2.0, 2000).astype(np.float32)
    jv = np.asarray(ji.grad_capped_sqrt(jnp.asarray(dmax), jnp.asarray(scale)))
    jg = np.asarray(jax.grad(lambda x: jnp.sum(ji.grad_capped_sqrt(x, jnp.asarray(scale))))(
        jnp.asarray(dmax)))
    x = torch.tensor(dmax, requires_grad=True)
    tv = ti.grad_capped_sqrt(x, torch.tensor(scale))
    (tg,) = torch.autograd.grad(tv.sum(), x)
    assert (np.abs(tv.detach().numpy() - jv) <= np.spacing(jv)).all()
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6)
    # The value is sqrt's up to one rounding of sg(x - y) + y, not bit-equal.
    assert (tv.detach().numpy() != np.sqrt(dmax)).any()


def test_silhouette_logit_matches_jax():
    u = np.concatenate([np.arange(0, 2**24, 97) * 2.0**-24, [2.0**-24, 1 - 2.0**-24]])
    u = u.astype(np.float32)
    got = ti.silhouette_logit(torch.tensor(u)).numpy()
    want = np.asarray(ji.silhouette_logit(jnp.asarray(u)))
    size = np.abs(np.log(np.maximum(u, 1e-30))) + np.abs(np.log(np.maximum(1 - u, 1e-30)))
    assert (np.abs(got - want) <= 2 * np.spacing(size.astype(np.float32))).all()
    assert got[0] == -30.0 and np.abs(got).max() == 30.0


def _rays(n, rng):
    """Rays from around the cover scene's camera toward its spheres, and
    from points on and near the ground (secondary bounces)."""
    o = np.where(
        (rng.random(n) < 0.5)[:, None],
        np.array([13.0, 2.0, 3.0]) + rng.normal(0, 0.5, (n, 3)),
        rng.uniform(-8, 8, (n, 3)) * np.array([1.0, 0.0, 1.0]) + np.array([0.0, 0.2, 0.0]),
    )
    tgt = rng.uniform(-6, 6, (n, 3)) * np.array([1.0, 0.15, 1.0]) + np.array([0.0, 0.3, 0.0])
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def soft_hits():
    scene = compact_scene(spt.cover_scene(jax.random.PRNGKey(0), max_spheres=512))
    rng = np.random.default_rng(2)
    n = 4096
    o, d = _rays(n, rng)
    u = (np.floor(rng.random(n) * 2**24) * 2.0**-24).astype(np.float32)
    uv = (np.floor(rng.random(n) * 2**24) * 2.0**-24).astype(np.float32)
    prev = np.where(rng.random(n) < 0.3, rng.integers(0, scene.num_spheres, n), -1)
    jh, jb = ji.intersect_scene_soft(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(u), jnp.asarray(uv), scene,
        1e-3, 3.0e7, SOFT, prev_idx=jnp.asarray(prev, jnp.int32),
    )
    tscene = convert_scene(scene, "cpu")
    th, tb = ti.intersect_scene_soft(
        torch.tensor(o), torch.tensor(d), torch.tensor(u), torch.tensor(uv), tscene,
        1e-3, 3.0e7, SOFT, prev_idx=torch.tensor(prev),
    )
    return jh, jb, th, tb


def test_intersect_scene_soft_matches_jax(soft_hits):
    jh, jb, th, tb = soft_hits
    j_idx = np.where(np.asarray(jh.hit), np.asarray(jh.index), -1)
    t_idx = np.where(th.hit.numpy(), th.index.numpy(), -1)
    same = (j_idx == t_idx) & (np.asarray(jb) == tb.numpy())
    n = same.size
    assert (~same).sum() <= 0.005 * n, (~same).sum()
    # The scan is exercised: hits, misses and blockers all common.
    assert (t_idx >= 0).sum() > n // 4 and (t_idx < 0).sum() > n // 20
    assert (tb.numpy() >= 0).sum() > n // 10
    hit = same & (t_idx >= 0)
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-4)
    np.testing.assert_allclose(th.normal.numpy()[hit], np.asarray(jh.normal)[hit],
                               rtol=1e-4, atol=1e-4)
