"""The frozen reference against the program's plain routes on the CPU, at
48 x 24 and up to 8 spp (this test imports both; the reference imports
nothing of the program)."""

import numpy as np
import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import scenes as pscenes
from simplepathtracer_tpu_torch.ops import sampling
from simplepathtracer_tpu_torch.ops.persistent import render_block_persistent_reference
from simplepathtracer_tpu_torch.render import _persistent_args

from pb_core import program, spec
from pb_drivers import fit as fit_driver
from pb_reference import camera, forward, grad as ref, rng, scene

COVER = spec.load_json(spec.BENCH_DIR / "configs" / "cover.json")


def _setup(seed, w=48, h=24, spp=8):
    cfg = program.render_block(COVER, width=w, height=h, spp=spp)
    tables = scene.to_device(scene.make_tables(dict(COVER["scene"], seed=seed)), "cpu")
    cam = camera.make_camera(COVER["camera"], "cpu")
    return cfg, tables, cam, rng.key_from_seed(seed * 1_000_003 + 2**40)


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
def test_threefry_and_tables_are_the_program_s(seed):
    k = rng.key_from_seed(seed)
    assert rng.fold_in(k, 5) == tuple(int(x) for x in sampling.fold_in(torch.tensor(k), 5))
    c = torch.arange(100)
    a = rng.threefry2x32(k[0], k[1], c, c * 7)
    b = sampling.threefry2x32(k[0], k[1], c, c * 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    t = scene.make_tables(dict(COVER["scene"], seed=seed))
    p = pscenes.compact_scene(pscenes.cover_scene(seed, device="cpu"))
    assert np.array_equal(t.centers, p.centers.numpy())
    assert np.array_equal(t.albedo, p.albedo.numpy())
    assert np.array_equal(t.material, p.material.numpy())


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_is_the_plain_persistent_version_bit_for_bit(seed):
    cfg, tables, cam, key = _setup(seed, spp=4)
    ids = torch.arange(48 * 24)
    sums, _ = forward.pixel_sums(tables, camera.camera_constants(cam, 48, 24), key, ids, 0, 4, cfg)
    ps, pc = program.scene(tpt, tables), program.camera(tpt, cam)
    t, sky6, cam19 = _persistent_args(ps, pc, program.render_config(tpt, cfg))
    want = render_block_persistent_reference(ids, t, sky6, cam19, program.key_tensor(key), 0, 4,
                                             10, 48, 24)
    assert torch.equal(sums, want)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("seed", [3, 4])
def test_scene_gradient_is_the_regen_route_s(seed):
    cfg, tables, cam, key = _setup(seed)
    with torch.no_grad():
        sums, _ = ref.pixel_sums(tables, rng.fold_in(key, 1000), torch.arange(48 * 24), 0, 8,
                                 cfg, 0.02, cam19=camera.camera_constants(cam, 48, 24))
    target = (sums / 8).reshape(24, 48, 3)
    s0 = fit_driver.start_scene(tables, spec.load_json(
        spec.BENCH_DIR / "traffic" / "fit_soft.json")["start"])
    pcfg = program.render_config(tpt, cfg, {"use_pallas": False, "use_pallas_grad": True,
                                            "grad_regen": True, "silhouette_softness": 0.02})
    params = {k: s0[k].clone().requires_grad_(True) for k in ref.SCENE_LEAVES}
    k0 = rng.fold_in(key, 0)
    loss = tpt.pixel_loss_decoupled(params, program.scene(tpt, s0), target,
                                    program.camera(tpt, cam), pcfg, program.key_tensor(k0),
                                    device="cpu")
    loss.backward()
    want, grads, segs = ref.loss_and_grad({k: s0[k] for k in ref.SCENE_LEAVES},
                                          {"scene": s0, "camera": cam}, target, k0, cfg, 0.02,
                                          camera=False, decoupled=True)
    assert segs > 48 * 24 * 8
    assert _rel(loss.detach(), want) < 1e-6
    for k, p in params.items():
        assert _rel(p.grad.norm(), grads[k].norm()) < 1e-3, k


def test_camera_gradient_is_the_fused_route_s():
    cfg, tables, cam, key = _setup(5, w=96, h=48, spp=16)
    with torch.no_grad():
        sums, _ = ref.pixel_sums(tables, rng.fold_in(key, 1000), torch.arange(96 * 48), 0, 8,
                                 cfg, 0.02, cam19=camera.camera_constants(cam, 96, 48))
    target = (sums / 8).reshape(48, 96, 3)
    c0 = fit_driver.start_camera(cam, spec.load_json(
        spec.BENCH_DIR / "traffic" / "fit_camera.json")["start"])
    pcfg = program.render_config(tpt, cfg, {"use_pallas": False, "use_pallas_grad": True,
                                            "silhouette_softness": 0.02})
    params = {k: c0[k].clone().requires_grad_(True) for k in fit_driver.CAMERA_LEAVES}
    k0 = rng.fold_in(key, 0)
    loss = tpt.camera_pixel_loss(params, program.camera(tpt, c0), program.scene(tpt, tables),
                                 target, pcfg, program.key_tensor(k0), decoupled=True,
                                 device="cpu")
    loss.backward()
    want, grads, _ = ref.loss_and_grad({k: c0[k] for k in fit_driver.CAMERA_LEAVES},
                                       {"scene": tables, "camera": c0}, target, k0, cfg, 0.02,
                                       camera=True, decoupled=True)
    assert _rel(loss.detach(), want) < 1e-6
    for k, p in params.items():
        assert _rel(p.grad.norm(), grads[k].norm()) < 1e-3, k

