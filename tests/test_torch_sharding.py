"""The port's ``parallel`` sharded render and gradient on gloo CPU processes,
against the JAX package (``tests/test_sharding.py``'s setup: three spheres,
32x16 at 8 spp, depth 4, key 7) and against the port's single-process
render and gradient.

One 4-rank job (``torch_dist_jobs.sharding_job``) runs the meshes 4x1, 2x2
and 1x4 over the same ranks; the 1x1 mesh runs in this process (a world of
one).  Bounds:

* every mesh's image against the JAX package's ``render`` of the same
  tables: ``atol=1e-5`` (``tests/test_sharding.py:47``);
* against the port's single-process ``render``: bit for bit where only
  tiles split (4x1, 1x1: each pixel sums its samples in the same order),
  ``atol=1e-5`` where samples split (per-rank partial sums added);
* the sharded loss and gradient against the port's single-process ones
  (the same loss by autograd): loss rtol 1e-5, gradients rtol 1e-5, atol
  1e-6 -- a gradient inflated by the samples count (the all-reduce's
  adjoint) would be 4x on 1x4;
* the smooth leaves (albedo, sky) against the JAX package's
  ``loss_and_grad_sharded`` on the conftest's fake devices, on the same
  2x2 mesh shape: rtol 2e-3, atol 2e-6 (the port's gradients against the
  JAX package's elsewhere, ``test_torch_grad_route.py``);
* two SGD steps lower the loss (``:77``); mesh validation raises (``:91``);
  a ``use_pallas`` config renders the same sharded (``:96``: < 1e-4 from
  the plain single-process render; the persistent kernel's plain version
  here).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_jobs as jobs
from simplepathtracer_tpu import scenes as jscenes
from simplepathtracer_tpu.parallel import loss_and_grad_sharded as j_loss_and_grad_sharded
from simplepathtracer_tpu.parallel import make_mesh as j_make_mesh
from simplepathtracer_tpu.types import RenderConfig as JConfig
from simplepathtracer_tpu.types import make_camera as j_make_camera

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import parallel
from simplepathtracer_tpu_torch.render import render_sample_batch

jrender = importlib.import_module("simplepathtracer_tpu.render")
CFG = jobs.CFG
SMOOTH = ("albedo", "sky_lo", "sky_hi")


def _jax_setup():
    return (jscenes.three_sphere_scene(),
            j_make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0),
            jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = jobs.run_job(jobs.sharding_job, 4, tmp_path_factory.mktemp("sharding"))
    ranks = [dict(np.load(f"{out}/rank{r}.npz")) for r in range(4)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"ranks disagree on {k}")
    return ranks[0]


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """A one-process group in this process, for the 1x1 mesh."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def single():
    """The port's single-process image, and its loss and gradient against
    the 0.25 target (the sharded loss written as one sum)."""
    scene, camera, key = jobs.setup()
    img = tpt.render(scene, camera, CFG, key).numpy()
    params, rest = parallel.split_scene(scene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    acc = render_sample_batch(rest.replace(**leaves), camera, CFG, key, 0, CFG.spp)
    mean = acc * (1.0 / CFG.spp)
    loss = torch.sum((mean - 0.25) ** 2) / (CFG.num_pixels * 3)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return img, loss.item(), {k: g.numpy() for k, g in zip(leaves, grads)}


@pytest.fixture(scope="module")
def jax_image():
    scene, cam, key = _jax_setup()
    return np.asarray(jrender.render(scene, cam, JConfig(width=32, height=16, spp=8,
                                                         max_depth=4), key))


@pytest.mark.parametrize("tiles,samples", jobs.MESHES)
def test_sharded_render_matches_jax_and_single_process(job, single, jax_image, tiles, samples):
    got = job[f"img_{tiles}x{samples}"]
    assert got.shape == (CFG.height, CFG.width, 3) and got.max() > 0
    np.testing.assert_allclose(got, jax_image, atol=1e-5, rtol=0)
    if samples == 1:
        np.testing.assert_array_equal(got, single[0])
    else:
        np.testing.assert_allclose(got, single[0], atol=1e-5, rtol=0)


def test_one_by_one_mesh_in_process(world_of_one, single, jax_image):
    scene, camera, key = jobs.setup()
    mesh = parallel.make_mesh(1, 1, device_type="cpu")
    got = parallel.render_sharded(scene, camera, CFG, key, mesh).numpy()
    np.testing.assert_array_equal(got, single[0])
    np.testing.assert_allclose(got, jax_image, atol=1e-5, rtol=0)
    # Mesh validation: the JAX package's messages, as ValueError.
    with pytest.raises(ValueError, match="mesh 3x3 != 1 devices"):
        parallel.make_mesh(tiles=3, samples=3, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible by samples=2"):
        parallel.make_mesh(samples=2, device_type="cpu")
    # Tensors on another device than the mesh's raise: nothing falls back.
    meta = jobs.setup(device="meta")
    with pytest.raises(ValueError, match="needs its tensors on cpu"):
        parallel.render_accum_sharded(meta[0], meta[1], CFG, key, mesh)


@pytest.mark.parametrize("tiles,samples", jobs.MESHES)
def test_sharded_grad_matches_single_process(job, single, tiles, samples):
    _, l_ref, g_ref = single
    tag = f"{tiles}x{samples}"
    np.testing.assert_allclose(job[f"loss_{tag}"], l_ref, rtol=1e-5)
    for k, want in g_ref.items():
        np.testing.assert_allclose(job[f"grad_{tag}_{k}"], want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{tag} {k}")


def test_sharded_grad_smooth_leaves_match_jax(job):
    scene, cam, key = _jax_setup()
    target = jnp.zeros((16, 32, 3), jnp.float32) + 0.25
    mesh = j_make_mesh(tiles=2, samples=2, devices=jax.devices()[:4])
    cfg = JConfig(width=32, height=16, spp=8, max_depth=4)
    # Under jit, as the JAX package's train step runs it (eager shard_map
    # takes a minute here).
    step = jax.jit(lambda s, t, c, k: j_loss_and_grad_sharded(s, t, c, cfg, k, mesh))
    l_j, g_j = step(scene, target, cam, key)
    np.testing.assert_allclose(job["loss_2x2"], float(l_j), rtol=1e-5)
    for k in SMOOTH:
        np.testing.assert_allclose(job[f"grad_2x2_{k}"], np.asarray(g_j[k]), rtol=2e-3,
                                   atol=2e-6, err_msg=k)


def test_train_step_decreases_loss(job):
    l1, l2 = job["train_losses"]
    assert l2 < l1, (l1, l2)


def test_sharded_pallas_render_matches_plain(job, single):
    a = job["img_pallas_2x2"]
    assert np.abs(a - single[0]).max() < 1e-4
