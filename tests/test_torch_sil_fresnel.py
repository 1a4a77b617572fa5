"""``SIL_FRESNEL`` (the detached Schlick-coin ratio, off by default) in the
port's gradient kernels' plain versions, against the JAX package with the
switch on in both packages.

Under soft silhouettes with ``intersect.SIL_FRESNEL`` on, a dielectric
hit's attenuation is p / stop_grad(p): 1.0 in value, so no forward value
changes, and its gradient is the realized Schlick coin's score, which
reaches ``ior`` and the geometry through cos_t and eta.  One case per
route, so the suite's workers run them side by side:

* the bounce: ``bounce_tile_adjoint`` against ``torch.autograd`` on
  ``bounce_tile`` and against ``jax.vjp`` on the JAX ``bounce_tile``
  (tiles and bounds of ``test_torch_soft_bounce.py``);
* the regen route: ``pixel_loss`` through the regeneration kernels' plain
  versions against the JAX regen route in Pallas interpret mode (case,
  pixels compared and bounds of ``test_torch_soft_route.py``:
  rtol 2e-3, atol 2e-6 per leaf, losses rtol 1e-6);
* the fused route: ``test_torch_sil_fresnel_fused.py`` (its own file, so
  the suite's workers run it beside this one).

Each also shows that the switch moves the ``ior`` gradient and leaves
every forward value bit for bit as it was.  The JAX package reads the
switch when it traces, so its caches are cleared around each toggle.
"""

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import test_torch_soft_bounce as sb
import test_torch_soft_route as sr
from simplepathtracer_tpu.ops import intersect as j_intersect
from simplepathtracer_tpu_torch.ops import intersect


@pytest.fixture
def fresnel(monkeypatch):
    """Turns the switch on in both packages (and back off after)."""
    jax.clear_caches()
    monkeypatch.setattr(j_intersect, "SIL_FRESNEL", True)
    monkeypatch.setattr(intersect, "SIL_FRESNEL", True)
    yield
    jax.clear_caches()


def _bounce_adjoint(t, rr_on, fresnel_on):
    groups, fx = sb._torch_args(t)
    cts = torch.tensor(t["cts"])
    ct = [tuple(cts[3 * i + c] for c in range(3)) for i in range(4)]
    g = sb.bounce_tile_adjoint(groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"],
                               fx["hit"], fx["alive"], fx["u"], groups["sky"], fx["do_rr"], *ct,
                               t_min=sb.T_MIN, t_max=sb.T_MAX, rr_on=rr_on, fresnel=fresnel_on,
                               **sb._soft_kw(t, groups))
    return [torch.stack(x).numpy() for x in (g.o, g.d, g.tp, g.a9, g.sky, g.blk4)]


def _bounce_autograd(t, rr_on, dtype=torch.float32):
    groups, fx = sb._torch_args(t, requires_grad=True, dtype=dtype)
    out = sb.bounce_tile(groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"],
                         fx["hit"], fx["alive"], fx["u"], groups["sky"], fx["do_rr"],
                         t_min=sb.T_MIN, t_max=sb.T_MAX, rr_on=rr_on, fresnel=True,
                         **sb._soft_kw(t, groups))
    vals = np.concatenate([torch.stack(x).detach().numpy() for x in out[:4]]
                          + [out[4].detach().numpy()[None]])
    cts = torch.tensor(t["cts"]).to(dtype)
    loss = sum((torch.stack(out[i]) * cts[3 * i:3 * i + 3]).sum() for i in range(4))
    ins = list(groups.values())
    gs = torch.autograd.grad(loss, [x for grp in ins for x in grp])
    grads, k = [], 0
    for grp in ins:
        grads.append(torch.stack(gs[k:k + len(grp)]).to(torch.float32).numpy())
        k += len(grp)
    return vals, grads


@pytest.mark.parametrize("seed,rr_on", [(10, False), (11, True)], ids=["spheres", "spheres-rr"])
def test_fresnel_bounce_matches_jax_and_autograd(fresnel, seed, rr_on):
    t = sb.make_soft_tile(seed, False)
    glass = t["alive"] & t["hit"] & (t["mat"] == 2)
    assert glass.sum() > 100
    jv, jg = sb._jax_vjp(t, rr_on)
    tv, tg = _bounce_autograd(t, rr_on)
    _, tg64 = _bounce_autograd(t, rr_on, torch.float64)
    extra = [10.0 * np.abs(a - b) for a, b in zip(tg, tg64)]
    if rr_on:
        scale = np.max([np.abs(g).max(axis=0) for g in _bounce_autograd(t, False)[1]], axis=0)
        extra = [e + 1e-5 * scale for e in extra]
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    ag = _bounce_adjoint(t, rr_on, True)
    for name, a, b, j, e in zip(sb.NAMES, tg, ag, jg, extra):
        sb.assert_soft_close(a, j, name, e)
        sb.assert_soft_close(b, a, name, e)
    # The switch moves the ior cotangent on glass lanes only, and leaves the
    # forward as it was.
    off = _bounce_adjoint(t, rr_on, False)
    moved = off[3][8] != ag[3][8]
    assert moved.sum() > 50 and not (moved & ~glass).any()
    groups, fx = sb._torch_args(t)
    args = (groups["o"], groups["d"], groups["tp"], groups["a9"], fx["mat"], fx["hit"],
            fx["alive"], fx["u"], groups["sky"], fx["do_rr"])
    kw = dict(t_min=sb.T_MIN, t_max=sb.T_MAX, rr_on=rr_on, **sb._soft_kw(t, groups))
    for a, b in zip(sb.bounce_tile(*args, fresnel=True, **kw), sb.bounce_tile(*args, **kw)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def _regen_port(scene, cam, cfg, seed, perm):
    return sr._port_grads(scene, cam, cfg, seed, True, perm)


def test_fresnel_regen_route_matches_jax(fresnel, monkeypatch):
    scene, cam, cfg, seed = sr._setup(False)
    perm = sr._kept_pixels(scene, cam, cfg, seed, True)
    l_j, g_j = sr._jax_grads(scene, cam, cfg, seed, True, perm)
    l_t, g_t = _regen_port(scene, cam, cfg, seed, perm)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    sr._assert_soft_grads_match(g_t, g_j, False)
    monkeypatch.setattr(intersect, "SIL_FRESNEL", False)
    l_off, g_off = _regen_port(scene, cam, cfg, seed, perm)
    assert l_off == l_t
    assert np.abs(g_off["ior"] - g_t["ior"]).max() > 1e-6
    # Glass only: the albedo and sky gradients do not move.
    for k in ("albedo", "sky_lo", "sky_hi"):
        np.testing.assert_array_equal(g_off[k], g_t[k], err_msg=k)
