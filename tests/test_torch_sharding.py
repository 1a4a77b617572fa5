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
* a ``use_pallas`` config (the persistent kernel's plain version here)
  renders the same sharded on every mesh (``:96``): where tiles split it
  deals the pixels by a probe's cost (``shard.dealt``, once a call) and
  changes no value -- 4x1 is the single-process ``render`` bit for bit,
  2x2 the single process's sum of the same two sample halves bit for bit
  (two partial sums add in either order alike), 1x4 (four partial sums,
  not dealt) within ``atol=1e-5``;
* ``deal_pixels``: each tile an equal share of a permutation of the
  pixels, costliest first, the tiles' costs within one pixel's, the same
  deal from every rank's sum of the probed bands; with one tile, the
  persistent kernel's pixel order: a stable sort by cost.
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
from simplepathtracer_tpu_torch.render import deal_pixels, render_sample_batch

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


@pytest.fixture(scope="module")
def single_pallas():
    """The single process's ``use_pallas`` images: {samples: image} of
    ``render`` (1) and of the sum of the two sample halves' sums (2), as
    the 2x2 mesh's all-reduce over ``samples`` adds them."""
    scene, camera, key = jobs.setup()
    cfg = CFG.replace(use_pallas=True)
    half = cfg.spp // 2
    halves = (render_sample_batch(scene, camera, cfg, key, 0, half)
              + render_sample_batch(scene, camera, cfg, key, half, half))
    state = tpt.RenderState(accum=halves.reshape(cfg.height, cfg.width, 3),
                            sample_count=cfg.spp, next_key=key)
    return {1: tpt.render(scene, camera, cfg, key).numpy(), 2: state.image(cfg.gamma).numpy()}


def test_sharded_pallas_render_matches_plain(job, single_pallas):
    for tiles, samples in jobs.MESHES:
        got = job[f"img_pallas_{tiles}x{samples}"]
        if samples in single_pallas:
            np.testing.assert_array_equal(got, single_pallas[samples], err_msg=f"{tiles}x{samples}")
        else:
            np.testing.assert_allclose(got, single_pallas[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("tiles,samples", jobs.MESHES)
def test_sharded_pallas_render_deals_where_tiles_split(job, tiles, samples):
    assert job[f"dealt_pallas_{tiles}x{samples}"] == (1 if tiles > 1 else 0)


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "distinct"])
def test_deal_pixels(nt, tied):
    g = torch.Generator().manual_seed(nt)
    p = 16 * 12
    # Costs that grow down the image, as a band of sky above spheres does.
    rows = torch.arange(p) // 16
    noise = torch.randint(0, 4, (p,), generator=g) if tied else torch.rand(p, generator=g) * 4
    counts = (rows // 3 + noise).float()
    ids = deal_pixels(counts, nt)
    assert ids.shape == (nt, p // nt)
    np.testing.assert_array_equal(np.sort(ids.reshape(-1).numpy()), np.arange(p))
    cost = counts[ids]
    assert bool((cost[:, 1:] <= cost[:, :-1]).all())
    sums = cost.sum(dim=1)
    assert (sums.max() - sums.min()).item() <= counts.max().item()
    if nt == 1:
        # One tile: the persistent kernel's pixel order, a stable sort by cost.
        np.testing.assert_array_equal(ids[0].numpy(), np.argsort(-counts.numpy(), kind="stable"))
    # Each rank sums the tiles' probed bands (zeros elsewhere) in its own
    # order: the same counts bit for bit, so the same deal.
    band = p // nt
    parts = []
    for t in range(nt):
        part = torch.zeros(p)
        part[t * band:(t + 1) * band] = counts[t * band:(t + 1) * band]
        parts.append(part)
    for r in range(nt):
        summed = torch.zeros(p)
        for t in range(nt):
            summed = summed + parts[(r + t) % nt]
        assert torch.equal(deal_pixels(summed, nt), ids)
