"""``pixel_loss`` gradients of the port against the JAX package, end to end.

* The regen route (``use_pallas_grad=True, grad_regen=True``), which on the
  CPU runs the regeneration kernels' plain versions, against the JAX regen
  route in Pallas interpret mode: Russian roulette off and on, a ground
  plane, the streamed-idx route over several chunks, and the checkpointed
  stream (the port's idx-plane budget shrunk as
  ``test_beyond_capacity_fallback_deterministic`` does for the JAX
  package, whose test holds that route bit-identical to its stream).
* The eager route (plain autograd through ``trace_rays``) against
  ``jax.grad`` through the JAX jnp path, Russian roulette off and on: the
  check on JAX's gradient rules at ties (``maximum``/``minimum``/``clip``
  split 0.5/0.5, ``jnp.max`` evenly).
* Within the port: the streamed-idx route against the chunked route (loss
  bit-identical, gradients to 1e-5) and the checkpointed stream against the
  streamed one (bit-identical).

The bound against JAX is JAX's own for its regen route
(``tests/test_pallas_grad_regen.py:test_regen_gradients_match_jnp``): loss
rtol 1e-6, every leaf's gradient rtol 2e-3, atol 2e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse as jinv
from simplepathtracer_tpu.scenes import with_ground_plane

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy

routes = importlib.import_module("simplepathtracer_tpu_torch.routes")
CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)


def _setup(plane=False, **kw):
    scene = spt.three_sphere_scene(hollow_glass=False)
    seed = 2
    if plane:
        scene = with_ground_plane(scene)
        scene = scene.replace(plane=jnp.asarray(scene.plane).at[3].set(0.6))
        seed = 7
    cfg = dict(width=16, height=8, spp=4, max_depth=4)
    cfg.update(kw)
    return scene, spt.make_camera(**CAM), cfg, seed


def _jax_loss_grads(scene, cam, cfg, seed, regen):
    c = spt.RenderConfig(**cfg)
    if regen:
        c = c.replace(use_pallas_grad=True, grad_regen=True, pallas_interpret=True)
    target = jnp.full((c.height, c.width, 3), 0.25, jnp.float32)
    params, static = jinv.split_params(scene)
    loss, grads = jax.value_and_grad(jinv.pixel_loss)(
        params, static, target, cam, c, jax.random.PRNGKey(seed)
    )
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_grads(scene, cam, cfg, seed, regen, **flags):
    c = tpt.RenderConfig(**cfg, **flags)
    if regen:
        c = c.replace(use_pallas_grad=True, grad_regen=True)
    ts, tc = convert_scene(scene, "cpu"), convert_camera(cam, "cpu")
    params, static = tpt.split_params(ts)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    target = torch.full((c.height, c.width, 3), 0.25)
    loss = tpt.pixel_loss(params, static, target, tc, c, tpt.make_key(seed), device="cpu")
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), params_to_numpy(dict(zip(params, grads)))


def assert_grads_match(got, want, rtol=2e-3, atol=2e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


REGEN_CASES = {
    "rr0": dict(),
    "rr2": dict(rr_start_depth=2),
    "plane": dict(plane=True),
    "stream": dict(spp=6, spp_chunk=2),
    # The stream case past the idx-plane budget: the port's checkpointed
    # stream.  The JAX package holds its own checkpointed stream bit-identical
    # to its stream (test_beyond_capacity_fallback_deterministic), so the
    # stream case's JAX result is the reference for both.
    "ckstream": dict(spp=6, spp_chunk=2),
}


@pytest.fixture(scope="module")
def jax_regen_results():
    """JAX regen-route (loss, gradients) by case, each computed once."""
    return {}


@pytest.fixture(scope="module", params=list(REGEN_CASES))
def regen_case(request, jax_regen_results):
    kw = dict(REGEN_CASES[request.param])
    scene, cam, cfg, seed = _setup(**kw)
    ref = "stream" if request.param == "ckstream" else request.param
    if ref not in jax_regen_results:
        jax_regen_results[ref] = _jax_loss_grads(scene, cam, cfg, seed, True)
    return request.param, scene, cam, cfg, seed, jax_regen_results[ref]


def test_regen_route_matches_jax_regen(regen_case, monkeypatch):
    name, scene, cam, cfg, seed, (l_j, g_j) = regen_case
    if name == "ckstream":
        monkeypatch.setattr(routes, "_IDX_PLANE_BUDGET", 1)
        assert routes.stream_capacity_spp(tpt.RenderConfig(**cfg), scene) < cfg["spp"]
    l_t, g_t = _port_loss_grads(scene, cam, cfg, seed, regen=True)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    if name == "plane":
        assert "plane" in g_t and np.abs(g_t["plane"][:3]).max() == 0.0  # normal detached
        assert np.abs(g_t["plane"][3:]).max() > 0.0
    assert_grads_match(g_t, g_j)


@pytest.mark.parametrize("rr", [0, 2])
def test_eager_route_matches_jax_grad(rr):
    scene, cam, cfg, seed = _setup(rr_start_depth=rr)
    l_j, g_j = _jax_loss_grads(scene, cam, cfg, seed, regen=False)
    l_t, g_t = _port_loss_grads(scene, cam, cfg, seed, regen=False)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    assert_grads_match(g_t, g_j)


@pytest.mark.parametrize("plane", [False, True], ids=["spheres", "plane"])
def test_stream_matches_chunked(plane):
    scene, cam, cfg, seed = _setup(plane=plane, width=32, height=16, spp=6, max_depth=5,
                                   spp_chunk=2, rr_start_depth=2)
    l_s, g_s = _port_loss_grads(scene, cam, cfg, seed, regen=True)
    l_c, g_c = _port_loss_grads(scene, cam, cfg, seed, regen=True, grad_regen_stream=False)
    assert l_s == l_c
    assert_grads_match(g_s, g_c, rtol=1e-5, atol=1e-7)


def test_checkpointed_stream_is_bit_identical(monkeypatch):
    scene, cam, cfg, seed = _setup(spp=6, spp_chunk=2, rr_start_depth=2)
    l_s, g_s = _port_loss_grads(scene, cam, cfg, seed, regen=True)
    monkeypatch.setattr(routes, "_IDX_PLANE_BUDGET", 1)
    l_f, g_f = _port_loss_grads(scene, cam, cfg, seed, regen=True)
    assert l_s == l_f
    for k in g_s:
        np.testing.assert_array_equal(g_f[k], g_s[k], err_msg=k)


def test_bank_count_changes_no_value():
    """``grad_regen_banks=2`` (each lane runs two pixels' chains back to
    back) gives the one-bank route's radiance bit for bit; its gradients
    differ only by the order of the per-lane partial sums."""
    scene, cam, cfg, seed = _setup(width=64, height=40, spp=2, max_depth=4, rr_start_depth=2)
    l_1, g_1 = _port_loss_grads(scene, cam, cfg, seed, regen=True)
    l_2, g_2 = _port_loss_grads(scene, cam, cfg, seed, regen=True, grad_regen_banks=2)
    assert l_1 == l_2
    assert_grads_match(g_2, g_1, rtol=1e-5, atol=1e-7)
