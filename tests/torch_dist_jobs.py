"""Rank functions of the port's multi-process CPU tests (gloo), and the
helper that runs them.

A test starts a job with ``run_job(fn, world_size, tmp_path, *args)``:
``world_size`` new processes (``parallel.spawn_local``, a file store under
``tmp_path``, at most ``JOB_TIMEOUT`` seconds), each running ``fn(rank,
world_size, out_dir, *args)`` on one torch thread.  Rank functions write
what the test checks to ``out_dir`` (``np.savez``, one file per rank
where ranks differ).  This module imports torch and the port only, so a
new process starts without JAX.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import checkpoint, inverse, parallel
from simplepathtracer_tpu_torch.render import render_sample_batch

# Seconds a job may take before every process is killed (the jobs here
# take a few seconds; a hung collective must fail the test, not the run).
JOB_TIMEOUT = 120.0
_jobs = itertools.count()

# tests/test_sharding.py's setup: three_sphere_scene, 32x16 at 8 spp,
# depth 4, key 7.
CFG = tpt.RenderConfig(width=32, height=16, spp=8, max_depth=4)
MESHES = ((4, 1), (2, 2), (1, 4))


def run_job(fn, world_size, tmp_path, *args):
    """Run ``fn`` on ``world_size`` gloo ranks; returns ``tmp_path``'s
    output directory for this job."""
    n = next(_jobs)
    out = os.path.join(str(tmp_path), f"job{n}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(str(tmp_path), f"store{n}")
    parallel.spawn_local(_entry, world_size, (fn, out, args),
                         init_method=f"file://{store}", backend="gloo", timeout=JOB_TIMEOUT)
    return out


def _entry(rank, world_size, fn, out, args):
    torch.set_num_threads(1)
    fn(rank, world_size, out, *args)


def setup(device="cpu"):
    scene = tpt.three_sphere_scene(device=device)
    camera = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60.0, device=device)
    return scene, camera, tpt.make_key(7)


def perturbed_target(cfg=CFG):
    """tests/test_sharding.py:77's target: the render of the scene with
    albedo + 0.2 (clipped), linear."""
    scene, camera, key = setup()
    truth = scene.replace(albedo=torch.clamp(scene.albedo + 0.2, 0, 1))
    with torch.no_grad():
        acc = render_sample_batch(truth, camera, cfg, key, 0, cfg.spp)
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)


def sharding_job(rank, world, out):
    """Every mesh of MESHES over the same 4 ranks: the sharded render, the
    sharded loss and gradient against a 0.25 target, the use_pallas render
    (persistent kernel's plain version) on 2x2, two SGD steps on 2x2."""
    scene, camera, key = setup()
    target = torch.full((CFG.height, CFG.width, 3), 0.25)
    res = {}
    for tiles, samples in MESHES:
        mesh = parallel.make_mesh(tiles, samples, device_type="cpu")
        tag = f"{tiles}x{samples}"
        res[f"img_{tag}"] = parallel.render_sharded(scene, camera, CFG, key, mesh).numpy()
        loss, grads = parallel.loss_and_grad_sharded(scene, target, camera, CFG, key, mesh)
        res[f"loss_{tag}"] = loss.numpy()
        res.update({f"grad_{tag}_{k}": v.numpy() for k, v in grads.items()})
        if (tiles, samples) == (2, 2):
            cfg_p = CFG.replace(use_pallas=True)
            res["img_pallas_2x2"] = parallel.render_sharded(scene, camera, cfg_p, key,
                                                            mesh).numpy()
            tgt = perturbed_target()
            s1, l1 = parallel.train_step_sharded(scene, tgt, camera, CFG, key, mesh, lr=0.5)
            _, l2 = parallel.train_step_sharded(s1, tgt, camera, CFG, key, mesh, lr=0.5)
            res["train_losses"] = np.array([l1.item(), l2.item()])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def distributed_job(rank, world, out):
    """make_multihost_mesh's shapes and errors, local_tile_slice's rows,
    initialize_cluster on a running group."""
    parallel.initialize_cluster()  # a group exists: nothing happens
    res = {}
    m = parallel.make_multihost_mesh(samples_per_host=2, device_type="cpu")
    res["shape_2"] = np.array([m.shape[0], m.shape[1]])
    m1 = parallel.make_multihost_mesh(samples_per_host=1, device_type="cpu")
    res["shape_1"] = np.array([m1.shape[0], m1.shape[1]])
    errors = []
    for s in (3, 0):
        try:
            parallel.make_multihost_mesh(samples_per_host=s, device_type="cpu")
        except ValueError:
            errors.append(s)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        parallel.make_multihost_mesh(samples_per_host=4, device_type="cpu")
    except ValueError:
        errors.append(4)
    del os.environ["LOCAL_WORLD_SIZE"]
    res["errors"] = np.array(errors)
    res["slice_2"] = np.array(parallel.local_tile_slice(m, 4096))
    res["slice_1"] = np.array(parallel.local_tile_slice(m1, 800))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def checkpoint_save_job(rank, world, out, mesh_shape, half):
    """Render [0, half) spp split over ``mesh_shape``, snapshot, and die
    without cleaning up (os._exit), as a killed job would."""
    scene, camera, key = setup()
    mesh = parallel.make_mesh(*mesh_shape, device_type="cpu")
    acc = parallel.render_accum_sharded(scene, camera, CFG, key, mesh, 0, half)
    checkpoint.save_sharded(os.path.join(out, "snap"), acc, half, key, scene, CFG, mesh, camera)
    os._exit(0)


def checkpoint_resume_job(rank, world, out, snap_dir, mesh_shape, half):
    """Resume the snapshot to CFG.spp; render the same two chunks without a
    snapshot; try a restore mesh of the other shape."""
    mesh = parallel.make_mesh(*mesh_shape, device_type="cpu")
    prefix = os.path.join(snap_dir, "snap")
    acc, done, key, scene, cfg, camera = checkpoint.load_sharded(prefix, mesh, device="cpu")
    more = parallel.render_accum_sharded(scene, camera, cfg, key, mesh, done, cfg.spp - done)
    resumed = parallel.gather_tiles(acc + more, cfg, mesh)
    s0, c0, k0 = setup()
    two = (parallel.render_accum_sharded(s0, c0, CFG, k0, mesh, 0, half)
           + parallel.render_accum_sharded(s0, c0, CFG, k0, mesh, half, CFG.spp - half))
    other = parallel.make_mesh(*mesh_shape[::-1], device_type="cpu")
    try:
        checkpoint.load_sharded(prefix, other, device="cpu")
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    np.savez(os.path.join(out, f"rank{rank}.npz"), resumed=resumed.numpy(),
             uninterrupted=parallel.gather_tiles(two, CFG, mesh).numpy(), done=done,
             same_config=cfg == CFG, mismatch=mismatch)


FIT_CFG = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=4)
FIT_STEPS, FIT_LR = 15, 5e-2


def fit_setup():
    """tests/test_inverse.py:11's setup and test_fit_sharded_recovers_albedo's
    start: the albedo + 0.25 (clipped to [0.05, 0.95]), its target the
    truth's render with fold_in(key, 999)."""
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    key = tpt.make_key(0)
    truth = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    with torch.no_grad():
        target = inverse.render_linear(truth, cam, FIT_CFG, tpt.fold_in(key, 999))
    start = truth.replace(albedo=torch.clamp(truth.albedo + 0.25, 0.05, 0.95))
    return truth, start, target, cam, key


def fit_job(rank, world, out, snap, resume):
    """fit_sharded of the albedo on a 1 x 2 mesh.  First job: the
    uninterrupted fit, then a fit of 8 steps with a snapshot after its
    last, and the job dies without cleaning up (os._exit).  ``resume``:
    the fit again, from that snapshot."""
    _, start, target, cam, key = fit_setup()
    mesh = parallel.make_mesh(1, world, device_type="cpu")

    def fit(steps, path, every):
        scene, losses = inverse.fit_sharded(
            start, target, cam, FIT_CFG, key, mesh, steps=steps, lr=FIT_LR,
            leaves=("albedo",), snapshot_path=path, snapshot_every=every, device="cpu")
        return dict(albedo=scene.albedo.numpy(), losses=np.array(losses))

    name = "resumed" if resume else "full"
    res = fit(FIT_STEPS, snap if resume else None, 100)
    np.savez(os.path.join(out, f"{name}{rank}.npz"), **res)
    if not resume:
        fit(8, snap, 8)
        os._exit(0)


def dead_peer_job(rank, world, out):
    """Rank 1 dies before the collective rank 0 waits in."""
    if rank == 1:
        os._exit(3)
    torch.distributed.all_reduce(torch.ones(4))


def sleeping_job(rank, world, out, seconds):
    import time

    time.sleep(seconds)
