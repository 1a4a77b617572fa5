"""The ``fit`` entry: ``inverse.fit`` run as its users run it, its steps the
window's work (closed loop).

Set-up makes the inputs from the seed: the true scene, the target (the
reference's render of the true scene at ``target_spp`` spp with the cell's
softness, key ``fold_in(key, target_key)``; timed apart and left out of
``setup_s``, since it is the reference's work) and the start (albedo and sky
scaled, some centers shifted).  Then the program's fit runs until the
window closes: its ``callback``, which runs after each step's synchronising
``loss.item()``, stamps the step's end; step 0 is set-up's warm-up, and the
window runs from its end until ``--seconds`` have passed, when the callback
ends the fit by raising ``WindowClosed``.  The fit starts again from the
start every ``restart_every`` steps (restart r keyed ``fold_in(key, 2^20 +
r)``), so every window holds the same kind of steps: a fit that runs on
moves the scene (free radii at lr 0.02) and with it the scan's work, so
that windows of one long fit differed by up to 5% from run to run.

The checked step is restart 1's first, a step the window timed; the traced
run profiles the step after it.  One step is checked: the reference takes
~27 s a step at the cells' size on an H100, and the check has to end within
the 30 s window.

The comparison (the training recipe): the reference takes the checked step
from the same start with the same key, with its own loss, gradient and Adam,
and the run reports the loss's relative gap (``loss_gap``), the worst leaf's
gap between the norms of the gradient as the optimizer got it
(``grad_gap``) and of the leaves' change by the update (``change_gap``),
each against the reference's norm of that leaf or the median leaf's,
whichever is larger.  Leaves whose reference gradient is under a thousandth
of the median leaf's are left out.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from pb_core import clock, harness
from pb_core import program as prog
from pb_core.trace import Tracer
from pb_drivers import render as _render
from pb_reference import camera, grad as ref, rng

CAMERA_LEAVES = ("origin", "lookat", "vfov_deg")
# Restart r > 0 of the fit is keyed fold_in(key, RESTART_KEY + r).
RESTART_KEY = 1 << 20
# The checked step is the first of this restart; the traced step follows it.
CHECK_RESTART = 1
TRACE_MARK = "step"


class WindowClosed(Exception):
    pass


def start_scene(tables: dict, start: dict) -> dict:
    t = dict(tables)
    if "albedo_scale" in start:
        t["albedo"] = tables["albedo"] * start["albedo_scale"]
    if "sky_scale" in start:
        t["sky_lo"] = tables["sky_lo"] * start["sky_scale"]
        t["sky_hi"] = tables["sky_hi"] * start["sky_scale"]
    if "center_shift" in start:
        cs = start["center_shift"]
        c = tables["centers"].clone()
        c[cs["slots"], cs["axis"]] += cs["delta"]
        t["centers"] = c
    return t


def start_camera(cam: dict, start: dict) -> dict:
    c = dict(cam)
    if "origin_shift" in start:
        c["origin"] = cam["origin"] + torch.tensor(start["origin_shift"], device=cam["origin"].device)
    if "vfov_shift" in start:
        c["vfov_deg"] = cam["vfov_deg"] + start["vfov_shift"]
    return c


def make_mask(tables: dict, spec: dict | None) -> dict | None:
    """{leaf: 0/1 tensor} from the traffic's ``mask`` block: ``slots`` and
    ``axes`` free (the rest frozen), or ``frozen`` slots (the rest free)."""
    if not spec:
        return None
    out = {}
    for leaf, m in spec.items():
        ref_t = tables[leaf]
        if "frozen" in m:
            mk = torch.ones_like(ref_t)
            mk[m["frozen"]] = 0.0
        else:
            mk = torch.zeros_like(ref_t)
            for s in m["slots"]:
                if "axes" in m:
                    mk[s, m["axes"]] = 1.0
                else:
                    mk[s] = 1.0
        out[leaf] = mk
    return out


def is_camera(ctx) -> bool:
    return ctx.cell.traffic["entry"] == "fit_camera"


def inputs(ctx):
    """The run's inputs from the seed, as ``harness.new_run`` fields:
    tables, target, start (scene0, cam0), mask, and the settings."""
    tr = ctx.cell.traffic
    tables, cam, rcfg, key = _render.inputs(ctx)
    softness = float(tr["softness"])
    width, height = int(rcfg["width"]), int(rcfg["height"])
    cam_fit = is_camera(ctx)
    # The target: the reference's render of the true scene, timed apart.
    t0 = time.perf_counter()
    with torch.no_grad():
        cam19 = camera.camera_constants(cam, width, height)
        sums, _ = ref.pixel_sums(tables, rng.fold_in(key, int(tr["target_key"])),
                                 torch.arange(width * height, device=ctx.device), 0,
                                 int(tr["target_spp"]), rcfg, softness, cam19=cam19)
        target = (sums / int(tr["target_spp"])).reshape(height, width, 3).contiguous()
    del sums
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    start = tr.get("start", {})
    scene0 = tables if cam_fit else start_scene(tables, start)
    cam0 = start_camera(cam, start) if cam_fit else cam
    mask = None if cam_fit else make_mask(tables, tr.get("mask"))
    return dict(tables=tables, scene0=scene0, cam=cam, cam0=cam0, mask=mask, target=target,
                rcfg=rcfg, key=key, softness=softness, camera=cam_fit, lr=float(tr["lr"]),
                restart_every=restart_every(tr), target_s=target_s)


def restart_every(tr: dict) -> int:
    n = int(tr["restart_every"])
    if n < 2:
        raise ValueError(f"restart_every is {n}: the checked and the traced step share a restart")
    return n


def restart_key(key, r: int):
    """Restart r's key; its step i is keyed ``fold_in(restart_key, i)``."""
    return key if r == 0 else rng.fold_in(key, RESTART_KEY + r)


def measure(ctx):
    tpt, tr = ctx.tpt, ctx.cell.traffic
    inp = inputs(ctx)
    scene0, cam0, mask, target = inp["scene0"], inp["cam0"], inp["mask"], inp["target"]
    rcfg, key, softness, cam_fit = inp["rcfg"], inp["key"], inp["softness"], inp["camera"]
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    p_scene, p_cam = prog.scene(tpt, scene0), prog.camera(tpt, cam0)
    pcfg = prog.render_config(tpt, rcfg, ctx.overrides.get("flags"))
    every = inp["restart_every"]
    check_step = CHECK_RESTART * every
    trace_step = check_step + 1
    tracer = Tracer() if ctx.trace else None
    st = {"marks": [], "snap": None, "summary": None, "peak_setup": 0, "n": 0}

    def callback(_, loss, params):
        now = time.perf_counter()
        i = st["n"]
        st["n"] += 1
        if i == check_step:
            st["snap"] = (float(loss),
                          {k: p.grad.detach().clone() for k, p in params.items()},
                          {k: p.detach().clone() for k, p in params.items()})
        if tracer is not None and i == trace_step:
            tracer.annotate_end(TRACE_MARK)
            st["summary"] = tracer.stop()
        if i == 0:
            st["setup_s"] = clock.process_age() - inp["target_s"]
            if ctx.device.type == "cuda":
                st["peak_setup"] = torch.cuda.max_memory_allocated(ctx.device)
                torch.cuda.reset_peak_memory_stats(ctx.device)
        if tracer is not None and i == trace_step - 1:
            tracer.start()
            tracer.annotate_begin(TRACE_MARK)
        if i == 0:
            st["marks"].append(time.perf_counter())
            return
        st["marks"].append(now)
        if (now - st["marks"][0] >= ctx.seconds and st["snap"] is not None
                and (tracer is None or st["summary"] is not None)):
            raise WindowClosed

    kw = dict(steps=every, lr=float(tr["lr"]), callback=callback, softness=softness,
              device=ctx.device)
    try:
        for r in range(1 << 30):
            key_r = prog.key_tensor(restart_key(key, r))
            if cam_fit:
                tpt.fit_camera(p_scene, target, p_cam, pcfg, key_r, **kw)
            else:
                tpt.fit(p_scene, target, p_cam, pcfg, key_r, param_mask=mask, **kw)
    except WindowClosed:
        pass
    marks = st["marks"]
    peak_window = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del p_scene, p_cam
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    steps = [b - a for a, b in zip(marks, marks[1:])]
    print("step ms: " + " ".join(f"{1e3 * x:.2f}" for x in steps), file=sys.stderr)
    return harness.new_run(
        attempted=len(steps), failed=0, peak_bytes=max(st["peak_setup"], peak_window),
        window_peak_bytes=peak_window, setup_s=st["setup_s"], window_s=marks[-1] - marks[0],
        steps=steps, trace=st["summary"], snap=st["snap"], **inp,
    )


def reference_steps(run, n_steps: int, dtype=torch.float32):
    """The reference's first ``n_steps`` steps of the checked restart, from
    the run's start: [(loss, gradients as the optimizer gets them, leaves
    after the step, segments)]."""
    key = restart_key(run.key, CHECK_RESTART)
    leaves = start_leaves(run)
    static = {"scene": run.scene0, "camera": run.cam0}
    adam = ref.Adam(leaves, run.lr, run.mask)
    out = []
    for s in range(n_steps):
        loss, g, segs = ref.loss_and_grad(leaves, static, run.target, rng.fold_in(key, s),
                                          run.rcfg, run.softness, camera=run.camera,
                                          decoupled=run.softness > 0.0, dtype=dtype)
        leaves = adam.step(leaves, g)
        out.append((loss, ref.masked(g, run.mask), leaves, segs))
    return out


def start_leaves(run) -> dict:
    if run.camera:
        return {k: run.cam0[k] for k in CAMERA_LEAVES}
    return {k: run.scene0[k] for k in ref.SCENE_LEAVES}


def compare(snap, want, start: dict, log=None) -> dict:
    """The three compared numbers of the program's checked step ``snap``
    (loss, gradients, leaves after the update) against the reference's
    ``want``; ``log`` (a print function) gets each leaf's norms.  The change
    is the restart's first update's: the second's differs between two sound
    runs by up to ~2% of a leaf's norm, because Adam moves a leaf entry whose
    gradient is near its eps by an amount that rounding decides, and the two
    trajectories part."""
    loss_gap = abs(snap[0] - want[0]) / abs(want[0])
    g_ref = {k: ref.norm(v) for k, v in want[1].items()}
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    g_prog = {k: ref.norm(snap[1][k].float()) for k in keep}
    d_ref = {k: ref.norm(want[2][k].float() - start[k].float()) for k in keep}
    d_prog = {k: ref.norm(snap[2][k].float() - start[k].float()) for k in keep}
    d_med = statistics.median(d_ref.values())
    if log is not None:
        for k in g_ref:
            log(f"leaf {k}: gradient norm {g_prog.get(k)!r} (reference {g_ref[k]!r})"
                + (f", change norm {d_prog[k]!r} (reference {d_ref[k]!r})" if k in keep
                   else ", left out"))
    grad_gap = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med) for k in keep)
    change_gap = max(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], d_med) for k in keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def check(ctx, run):
    # A traced run also needs the traced step's segments, counted by the
    # reference following the checked restart one step further.
    refs = reference_steps(run, 2 if run.trace is not None else 1)
    if run.trace is not None:
        run.segments = refs[1][3]
        run.live_spheres = int(torch.count_nonzero(_render._live(run.tables)))
    got = compare(run.snap, refs[0][:3], start_leaves(run),
                  log=lambda m: print(m, file=sys.stderr))
    limits = ctx.cell.workload["limits"]
    out = [(k, float(v), float(limits[k])) for k, v in got.items()]
    run.failed = int(any(v > lim for _, v, lim in out))
    return out
