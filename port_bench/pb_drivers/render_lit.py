"""The ``render_lit`` entry: back-to-back ``render()`` of one frame of a scene
whose spheres emit light, closed loop.

As the ``render`` entry (``pb_drivers.render``): frame i renders with the
key ``fold_in(key, i)``, a frame is timed from the call until
``torch.cuda.synchronize()`` returns, the checked pixels are copied out of
every frame, set-up renders one frame with a key no window frame uses,
and the traced run profiles ``TRACE_FRAMES`` frames from frame 1 on.  The
scene is the configuration's explicit table (``scene.spheres``), handed to
the program as a ``Scene`` with its ``emission``; a program whose ``Scene``
has no emission cannot run the cell and exits before set-up.

The comparison: ``flip_share`` against ``pb_reference.forward_lit`` (the
forward trace with the emission term) on the checked pixels of
``CHECK_FRAMES`` frames; on a GPU also ``unlit_frame_share``, the share of
the window's frames for which the program launched no emissive build of
its forward kernel (the ``launch.persistent.emit`` counter), which must be
0.  The traced run also counts, by the reference over the whole traced
frame, the segments and threefry evaluations ``persistent_lit_roofline``
reads.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pb_core import clock, harness
from pb_core import program as prog
from pb_core.trace import Tracer
from pb_reference import camera, forward_lit, rng

from .render import (
    TRACE_FRAMES,
    TRACE_FROM,
    WARM_FRAME,
    _peak,
    check_pixels,
    checked_frames,
    flip_share,
)

EMIT_COUNTER = "launch.persistent.emit"


def inputs(ctx):
    """(the configuration's tables with their emission, on the device;
    camera; render block; the key, from the seed)."""
    cfg = ctx.cell.config
    tables = forward_lit.lit_tables(cfg["scene"], ctx.device)
    cam = camera.make_camera(cfg["camera"], ctx.device)
    rcfg = prog.render_block(cfg, **ctx.overrides.get("render", {}))
    return tables, cam, rcfg, rng.key_from_seed(ctx.seed)


def program_scene(tpt, tables):
    """The program's ``Scene`` with its emission; raises ``ProgramMissing``
    where the program's ``Scene`` has no emission leaf."""
    if "emission" not in {f.name for f in dataclasses.fields(tpt.Scene)}:
        raise prog.ProgramMissing("the program's Scene has no emission leaf: it cannot render "
                                  "an emitter-lit scene")
    return prog.scene(tpt, tables).replace(emission=tables["emission"].clone())


def measure(ctx):
    tpt, tr = ctx.tpt, ctx.cell.traffic
    tables, cam, rcfg, key = inputs(ctx)
    p_scene, p_cam = program_scene(tpt, tables), prog.camera(tpt, cam)
    pcfg = prog.render_config(tpt, rcfg, ctx.overrides.get("flags"))
    n_pix = pcfg.width * pcfg.height
    pix = check_pixels(ctx, n_pix, min(int(tr["check_pixels"]), n_pix))
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)

    def frame(i):
        return tpt.render(p_scene, p_cam, pcfg, prog.key_tensor(rng.fold_in(key, i)))

    frame(WARM_FRAME)
    sync()
    peak = _peak(ctx)
    setup_s = clock.process_age()
    tracer = Tracer() if ctx.trace else None
    summary, frames, kept = None, [], []
    emit_before = tpt.tracing.counts()[EMIT_COUNTER]
    t_start = time.perf_counter()
    i = 0
    while True:
        if tracer and i == TRACE_FROM:
            tracer.start()
        if tracer and TRACE_FROM <= i < TRACE_FROM + TRACE_FRAMES:
            tracer.annotate_begin(f"frame{i}")
        t0 = time.perf_counter()
        img = frame(i)
        sync()
        t1 = time.perf_counter()
        if tracer and TRACE_FROM <= i < TRACE_FROM + TRACE_FRAMES:
            tracer.annotate_end(f"frame{i}")
            if i == TRACE_FROM + TRACE_FRAMES - 1:
                summary = tracer.stop()
        frames.append(t1 - t0)
        kept.append(img.reshape(-1, 3)[pix])
        i += 1
        if t1 - t_start >= ctx.seconds and (tracer is None or summary is not None):
            break
    window = t1 - t_start
    emit_launches = tpt.tracing.counts()[EMIT_COUNTER] - emit_before
    peak = max(peak, _peak(ctx))
    del img
    return harness.new_run(
        attempted=len(frames), failed=0, peak_bytes=peak, setup_s=setup_s, window_s=window,
        frames=frames, paths=len(frames) * n_pix * pcfg.spp, trace=summary,
        traced_frame=TRACE_FROM if tracer else None, kept=kept, pix=pix, tables=tables,
        cam=cam, rcfg=rcfg, key=key, n_pix=n_pix, emit_launches=emit_launches,
    )


def reference_image(run, frame: int, dtype=torch.float32, emit=True, spp=None):
    """The reference's image at the checked pixels of window frame ``frame``
    (``emit=False``: without the emission term; ``spp``: fewer samples)."""
    spp = int(spp or run.rcfg["spp"])
    cam19 = camera.camera_constants(run.cam, run.rcfg["width"], run.rcfg["height"])
    sums, _ = forward_lit.pixel_sums(run.tables, cam19, rng.fold_in(run.key, frame), run.pix, 0,
                                     spp, run.rcfg, dtype, emit=emit)
    lin = torch.clamp(sums.float() / spp, 0.0, 1.0)
    return lin ** (1.0 / float(run.rcfg["gamma"]))


def check(ctx, run):
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    limit = float(ctx.cell.workload["limits"]["flip_share"])
    off = tot = 0
    for f in checked_frames(ctx, len(run.kept)):
        o, n = flip_share(run.kept[f], reference_image(run, f))
        off, tot = off + o, tot + n
        run.failed += int(o > limit * n)
    checks = [("flip_share", off / tot, limit)]
    if ctx.device.type == "cuda":
        unlit = max(0, len(run.frames) - int(run.emit_launches))
        checks.append(("unlit_frame_share", unlit / len(run.frames), 0.0))
    if run.trace is not None and run.traced_frame is not None:
        run.lit_work = frame_work(run, run.traced_frame)
        run.live_spheres = int(torch.count_nonzero(forward_lit.live(run.tables)))
    return checks


def frame_work(run, frame: int) -> dict:
    """Every path's segments and threefry evaluations in window frame
    ``frame``, counted by the reference."""
    cam19 = camera.camera_constants(run.cam, run.rcfg["width"], run.rcfg["height"])
    ids = torch.arange(run.n_pix, device=run.pix.device)
    _, work = forward_lit.pixel_sums(run.tables, cam19, rng.fold_in(run.key, frame), ids, 0,
                                     int(run.rcfg["spp"]), run.rcfg, chunk_paths=1 << 22)
    return work
