"""The ``render_sharded`` entry: back-to-back sharded frames on one process
per GPU (NCCL), closed loop.

The run's process builds or finds the kernel library, spawns the ranks
(the program's ``parallel.spawn_local``, backend ``nccl``, the rendezvous
file in a fresh directory under ``TMPDIR``) and touches no GPU until they
have ended.  Each
rank builds the same inputs from the seed, makes the configuration's mesh
(``make_mesh(tiles, samples)``) and renders one warm-up frame.  A frame is
``render_accum_sharded`` (each rank its band of rows) and ``gather_tiles``
(the all-reduce that gives every rank the whole image), keyed
``fold_in(key, i)``; rank 0 then says whether the window has closed (a
one-number all-reduce).  The traced run profiles ``TRACE_FRAMES`` frames on
every rank with a barrier before each frame and one between the render and
the gather, so each rank's render and rank 0's gather are timed apart.

Rank 0 copies the checked pixels out of each gathered image; the
comparison (once the ranks have ended, on the run's process) is the
``render`` entry's, at the configuration's spp.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

from pb_core import clock, harness
from pb_drivers import render as _render

TRACE_FROM = 1


def _rank(rank, world, cell, seed, seconds, trace, overrides, out_dir):
    import torch
    import torch.distributed as dist

    from pb_core import program as prog
    from pb_core.trace import Tracer
    from pb_reference import rng

    tpt = prog.load()
    from simplepathtracer_tpu_torch import parallel

    if overrides.get("rank_setup") is not None:
        overrides["rank_setup"]()

    cpu = bool(overrides.get("cpu"))
    dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=dev,
                          tpt=tpt, overrides=overrides)
    tables, cam, rcfg, key = _render.inputs(ctx)
    p_scene, p_cam = prog.scene(tpt, tables), prog.camera(tpt, cam)
    pcfg = prog.render_config(tpt, rcfg)
    mesh_cfg = cell.config["mesh"]
    mesh = parallel.make_mesh(tiles=int(mesh_cfg["tiles"]), samples=int(mesh_cfg["samples"]),
                              device_type="cpu" if cpu else None)
    n_pix = pcfg.width * pcfg.height
    pix = _render.check_pixels(ctx, n_pix, min(int(cell.traffic["check_pixels"]), n_pix))
    spp = pcfg.spp

    def render(i):
        return parallel.render_accum_sharded(p_scene, p_cam, pcfg,
                                             prog.key_tensor(rng.fold_in(key, i)), mesh)

    full = parallel.gather_tiles(render(_render.WARM_FRAME), pcfg, mesh)
    sync()
    dist.barrier()
    peak = 0 if cpu else torch.cuda.max_memory_allocated(dev)
    tracer = Tracer() if trace else None
    summary, frames, kept, render_s, gather_s = None, [], [], [], []
    stop = torch.zeros(1, device=dev)
    t_start = time.perf_counter()
    wall_start = time.time()
    i = 0
    while True:
        traced = tracer is not None and TRACE_FROM <= i < TRACE_FROM + _render.TRACE_FRAMES
        if tracer is not None and i == TRACE_FROM:
            tracer.start()
        if traced:
            dist.barrier()
            tracer.annotate_begin(f"frame{i}")
        t0 = time.perf_counter()
        acc = render(i)
        if traced:
            sync()
            t1 = time.perf_counter()
            dist.barrier()
            t2 = time.perf_counter()
        full = parallel.gather_tiles(acc, pcfg, mesh)
        sync()
        t3 = time.perf_counter()
        if traced:
            tracer.annotate_end(f"frame{i}")
            render_s.append(t1 - t0)
            gather_s.append(t3 - t2)
            if i == TRACE_FROM + _render.TRACE_FRAMES - 1:
                summary = tracer.stop()
        frames.append(t3 - t0)
        if rank == 0:
            img = torch.clamp(full[pix] / spp, 0.0, 1.0) ** (1.0 / pcfg.gamma)
            kept.append(img.cpu())
        i += 1
        done = t3 - t_start >= seconds and (tracer is None or summary is not None)
        stop.fill_(1.0 if (rank == 0 and done) else 0.0)
        dist.all_reduce(stop, op=dist.ReduceOp.MAX)
        if stop.item() > 0:
            break
    t_end = time.perf_counter()
    peak = max(peak, 0 if cpu else torch.cuda.max_memory_allocated(dev))
    rec = {"rank": rank, "frames": frames, "window_s": t_end - t_start, "wall_start": wall_start,
           "render_s": render_s, "gather_s": gather_s, "peak": int(peak), "trace": summary,
           "kept": kept, "pix": pix.cpu(), "n_pix": n_pix, "spp": spp}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def measure(ctx):
    from simplepathtracer_tpu_torch import parallel

    world = int(ctx.cell.chips)
    wall0 = time.time() - clock.process_age()
    if not ctx.overrides.get("cpu"):
        # Build (or find) the kernel library here, so that the ranks load
        # one build and never run nvcc into one directory together; this
        # touches no GPU.
        from simplepathtracer_tpu_torch.ops.cuda_build import load_library

        load_library()
    tmp = tempfile.mkdtemp(prefix="port_bench_ranks_")
    try:
        store = os.path.join(tmp, "rendezvous")
        parallel.spawn_local(_rank, world, args=(ctx.cell, ctx.seed, ctx.seconds, ctx.trace,
                                                 ctx.overrides, tmp),
                             init_method=f"file://{store}",
                             backend="gloo" if ctx.overrides.get("cpu") else "nccl",
                             timeout=300.0 + ctx.seconds)
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = recs[0]
    tables, cam, rcfg, key = _render.inputs(ctx)
    frames = r0["frames"]
    run = harness.new_run(
        attempted=len(frames), failed=0, peak_bytes=max(r["peak"] for r in recs),
        setup_s=r0["wall_start"] - wall0, window_s=r0["window_s"], frames=frames,
        paths=len(frames) * r0["n_pix"] * r0["spp"], trace=r0["trace"],
        rank_traces=[r["trace"] for r in recs if r["trace"] is not None],
        rank_render_s=[r["render_s"] for r in recs], gather_s=r0["gather_s"],
        kept=[k.to(ctx.device) for k in r0["kept"]], pix=r0["pix"].to(ctx.device),
        tables=tables, cam=cam, rcfg=rcfg, key=key, n_pix=r0["n_pix"],
        traced_frame=None,
    )
    return run


def check(ctx, run):
    return _render.check(ctx, run)
