"""Sharded render snapshots (``checkpoint.save_sharded`` / ``load_sharded``),
as ``tests/test_checkpoint.py:65`` and ``:101`` hold the JAX package's.

* A 2-rank render (tiles 2 x 1, and samples 1 x 2; and tiles 2 x 1 on
  the persistent route, whose pixels are dealt by cost) saves after half
  its spp and dies (``os._exit``, no cleanup); a new job loads the
  snapshot and renders the rest.  Its sums are bit for bit those of one
  uninterrupted job that renders the same two chunks (each pixel sums its
  samples in the same order), and the snapshot's config is the render's.
  Each file holds its process's band of rows whatever pixels it rendered:
  on the persistent route, bit for bit the single process's sums of them.
* Restoring with a mesh of another shape raises ``ValueError``.
* At world size 1 the port's snapshot loads in the JAX package and the
  JAX package's in the port (the same rows, key, scene and config).
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_jobs as jobs
from simplepathtracer_tpu import checkpoint as jcheckpoint
from simplepathtracer_tpu import scenes as jscenes
from simplepathtracer_tpu.parallel import make_mesh as j_make_mesh
from simplepathtracer_tpu.parallel import render_accum_sharded as j_render_accum_sharded
from simplepathtracer_tpu.types import RenderConfig as JConfig
from simplepathtracer_tpu.types import make_camera as j_make_camera

from simplepathtracer_tpu_torch import checkpoint, parallel
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene
from simplepathtracer_tpu_torch.render import render_sample_batch

HALF = 4


@pytest.mark.parametrize("mesh_shape,pallas", [((2, 1), False), ((1, 2), False), ((2, 1), True)],
                         ids=["tiles", "samples", "tiles_pallas"])
def test_sharded_render_resumes_bit_identically(tmp_path, mesh_shape, pallas):
    snap = jobs.run_job(jobs.checkpoint_save_job, 2, tmp_path, mesh_shape, HALF, pallas)
    assert sorted(f for f in os.listdir(snap) if f.endswith(".npz")) == [
        "snap.proc0of2.npz", "snap.proc1of2.npz"]
    if pallas:
        scene, camera, key = jobs.setup()
        cfg = jobs.checkpoint_config(pallas)
        whole = render_sample_batch(scene, camera, cfg, key, 0, HALF).numpy()
        rows = cfg.num_pixels // 2
        for r in range(2):
            z = np.load(f"{snap}/snap.proc{r}of2.npz")
            assert (int(z["row_start"]), int(z["row_size"])) == (r * rows, rows)
            np.testing.assert_array_equal(z["accum_rows"], whole[r * rows:(r + 1) * rows])
    out = jobs.run_job(jobs.checkpoint_resume_job, 2, tmp_path, snap, mesh_shape, HALF, pallas)
    for r in range(2):
        z = np.load(f"{out}/rank{r}.npz")
        assert int(z["done"]) == HALF and bool(z["same_config"])
        np.testing.assert_array_equal(z["resumed"], z["uninterrupted"])
        assert z["resumed"].max() > 0
        assert "does not match the restore mesh" in str(z["mismatch"])


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def _jax_setup():
    scene = jscenes.three_sphere_scene()
    cam = j_make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0)
    cfg = JConfig(width=32, height=16, spp=8, max_depth=4)
    return scene, cam, cfg, jax.random.PRNGKey(3)


def test_world_of_one_snapshot_loads_across_packages(tmp_path, world_of_one):
    jscene, jcam, jcfg, jkey = _jax_setup()
    jmesh = j_make_mesh(tiles=1, samples=1, devices=jax.devices()[:1])
    mesh = parallel.make_mesh(1, 1, device_type="cpu")
    scene, cam = convert_scene(jscene, "cpu"), convert_camera(jcam, "cpu")
    cfg = jobs.CFG
    key = torch.as_tensor(np.asarray(jkey).astype(np.int64))

    # The port's snapshot into the JAX package.
    acc = parallel.render_accum_sharded(scene, cam, cfg, key, mesh, 0, HALF)
    port_prefix = str(tmp_path / "port")
    assert checkpoint.save_sharded(port_prefix, acc, HALF, key, scene, cfg, mesh,
                                   cam).endswith(".proc0of1.npz")
    acc_j, done, key_j, scene_j, cfg_j, cam_j = jcheckpoint.load_sharded(port_prefix, jmesh)
    assert done == HALF and cfg_j == jcfg and cam_j is not None
    np.testing.assert_array_equal(np.asarray(acc_j), acc.numpy())
    np.testing.assert_array_equal(np.asarray(key_j), np.asarray(jkey))
    np.testing.assert_array_equal(np.asarray(scene_j.centers), np.asarray(jscene.centers))

    # The JAX package's snapshot into the port.
    jacc = j_render_accum_sharded(jscene, jcam, jcfg, jkey, jmesh, 0, HALF)
    jax_prefix = str(tmp_path / "jax")
    jcheckpoint.save_sharded(jax_prefix, jacc, HALF, jkey, jscene, jcfg, jmesh, jcam)
    acc_t, done, key_t, scene_t, cfg_t, cam_t = checkpoint.load_sharded(jax_prefix, mesh,
                                                                        device="cpu")
    assert done == HALF and cfg_t == cfg and cam_t is not None
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(jacc))
    assert torch.equal(key_t, key)
    assert torch.equal(scene_t.radii, scene.radii) and torch.equal(cam_t.origin, cam.origin)
    # The two packages' sums of the same samples agree to rounding.
    np.testing.assert_allclose(acc_t.numpy(), acc.numpy(), atol=1e-4 * HALF, rtol=0)
