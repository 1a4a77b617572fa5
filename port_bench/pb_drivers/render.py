"""The ``render`` entry: back-to-back ``render()`` of one frame, closed loop.

Frame i renders with the key ``fold_in(key, i)``; a frame is timed from the
call until ``torch.cuda.synchronize()`` returns.  After each frame's time
is taken, the pixels the comparison reads (``check_pixels`` of them, drawn
from the seed) are copied out of its image.  Set-up renders one frame with
a key no window frame uses.  The traced run profiles ``TRACE_FRAMES``
frames from frame 1 on.

The comparison: once the window has closed, the reference renders the
checked pixels of ``CHECK_FRAMES`` frames (the last, and others drawn from
the seed) over all samples, and ``flip_share`` is the share of checked
pixels where a channel of the image differs from the reference's by more
than ``FLIP_TOL`` (a path that took another branch; rounding moves a pixel
by ~1e-7).
"""

from __future__ import annotations

import random
import time

import torch

from pb_core import clock, harness
from pb_core import program as prog
from pb_core.trace import Tracer
from pb_reference import camera, forward, rng, scene

FLIP_TOL = 1e-4
WARM_FRAME = 0xFFFFFFFF
TRACE_FROM = 1
TRACE_FRAMES = 3
CHECK_FRAMES = 3


def inputs(ctx):
    """The benchmark's inputs: (the configuration's tables on the device,
    camera and render block; the key, from the seed)."""
    cfg = ctx.cell.config
    tables = scene.to_device(scene.make_tables(cfg["scene"]), ctx.device)
    cam = camera.make_camera(cfg["camera"], ctx.device)
    rcfg = prog.render_block(cfg, **ctx.overrides.get("render", {}))
    return tables, cam, rcfg, rng.key_from_seed(ctx.seed)


def check_pixels(ctx, n_pixels: int, n: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(ctx.seed) ^ 0x5EED5EED)
    return torch.randperm(n_pixels, generator=gen)[:n].sort().values.to(ctx.device)


def measure(ctx):
    tpt, tr = ctx.tpt, ctx.cell.traffic
    tables, cam, rcfg, key = inputs(ctx)
    p_scene, p_cam = prog.scene(tpt, tables), prog.camera(tpt, cam)
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
    peak = max(peak, _peak(ctx))
    del img
    return harness.new_run(
        attempted=len(frames), failed=0, peak_bytes=peak, setup_s=setup_s, window_s=window,
        frames=frames, paths=len(frames) * n_pix * pcfg.spp, trace=summary,
        traced_frame=TRACE_FROM if tracer else None, kept=kept, pix=pix, tables=tables,
        cam=cam, rcfg=rcfg, key=key, n_pix=n_pix,
    )


def _peak(ctx) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def reference_image(run, frame: int, dtype=torch.float32):
    """The reference's image at the checked pixels of window frame ``frame``."""
    cam19 = camera.camera_constants(run.cam, run.rcfg["width"], run.rcfg["height"])
    sums, _ = forward.pixel_sums(run.tables, cam19, rng.fold_in(run.key, frame), run.pix, 0,
                                 int(run.rcfg["spp"]), run.rcfg, dtype)
    lin = torch.clamp(sums.float() / int(run.rcfg["spp"]), 0.0, 1.0)
    return lin ** (1.0 / float(run.rcfg["gamma"]))


def checked_frames(ctx, n_frames: int) -> list[int]:
    r = random.Random(int(ctx.seed) * 7919 + 17)
    others = r.sample(range(n_frames - 1), min(CHECK_FRAMES - 1, n_frames - 1))
    return sorted(set(others) | {n_frames - 1})


def flip_share(prog_img, ref_img) -> tuple[int, int]:
    """(pixels with a channel off by more than FLIP_TOL, pixels)."""
    off = (prog_img.float() - ref_img.float()).abs().amax(-1) > FLIP_TOL
    off = off | ~torch.isfinite(prog_img).all(-1)
    return int(off.sum()), int(off.numel())


def check(ctx, run):
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    limit = float(ctx.cell.workload["limits"]["flip_share"])
    off = tot = 0
    for f in checked_frames(ctx, len(run.kept)):
        o, n = flip_share(run.kept[f], reference_image(run, f))
        off, tot = off + o, tot + n
        run.failed += int(o > limit * n)
    if run.trace is not None and run.traced_frame is not None:
        run.segments = frame_segments(run, run.traced_frame)
        run.live_spheres = int(torch.count_nonzero(_live(run.tables)))
    return [("flip_share", off / tot, limit)]


def _live(tables):
    return (tables["radii"].abs() > 1e-3) & (tables["centers"][:, 1] > -1e6)


def frame_segments(run, frame: int) -> int:
    """Every path's segments in window frame ``frame``, counted by the
    reference: the brute-force scan's work."""
    cam19 = camera.camera_constants(run.cam, run.rcfg["width"], run.rcfg["height"])
    ids = torch.arange(run.n_pix, device=run.pix.device)
    _, segs = forward.pixel_sums(run.tables, cam19, rng.fold_in(run.key, frame), ids, 0,
                                 int(run.rcfg["spp"]), run.rcfg)
    return segs
