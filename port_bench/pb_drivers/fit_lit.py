"""The ``fit_lit`` entry: ``inverse.fit`` of a scene whose spheres emit
light, run as its users run it, its steps the window's work (closed loop).

As the ``fit`` entry (``pb_drivers.fit``: its window, its restarts every
``restart_every`` steps, its checked step, restart 1's first, and the
traced step after it, and its comparison ``compare``), with three changes:

* the scene is the configuration's explicit table with its emission
  (``pb_drivers.render_lit``), handed to the program as a ``Scene`` with
  ``emission``, and the fitted leaves are the traffic's ``leaves`` (the
  emission among them); the start may also scale the emission
  (``emission_scale``);
* the reference is ``pb_reference.grad_lit`` (the differentiable trace
  with the emission term): it renders the target (timed apart and left
  out of ``setup_s``) and takes the checked step;
* on a GPU the run also reads ``unlit_step_share``: the share of the
  checked and traced steps in which the program launched no emissive build
  of its backward kernel (``launch.regen_backward.<variant>.emit``), which
  must be 0.  A traced run counts, by the reference's forward passes, the
  traced step's work that the ``regen_*_lit_roofline`` readers read.

The reference works on ``CHUNK_PATHS`` paths at a time: a checked step of
the cell (50 M paths in two passes, one pulled back) then takes fewer,
larger launches.

A program whose fit carries no emission raises on the warm-up step: the
run prints no result and exits non-zero.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from pb_core import clock, harness
from pb_core import program as prog
from pb_core.trace import Tracer
from pb_drivers import fit as _fit
from pb_drivers import render_lit as _lit
from pb_reference import camera, forward_lit, grad_lit as ref, rng

# Paths the reference traces at a time: 8 Mi (it tries on about 10 GB of
# the card's memory at the cell's size, which the program has released).
CHUNK_PATHS = 1 << 23


def emit_counter(softness: float) -> str:
    """The counter of the backward's emissive launches of the cell's
    variant (a sphere-only scene: hard or soft)."""
    return f"launch.regen_backward.{'soft' if softness > 0.0 else 'hard'}.emit"


def start_scene(tables: dict, start: dict) -> dict:
    """``fit.start_scene``'s start, the emission scaled by
    ``emission_scale``."""
    t = _fit.start_scene(tables, start)
    if "emission_scale" in start:
        t["emission"] = tables["emission"] * start["emission_scale"]
    return t


def inputs(ctx):
    """The run's inputs from the seed, as ``harness.new_run`` fields."""
    tr = ctx.cell.traffic
    tables, cam, rcfg, key = _lit.inputs(ctx)
    softness = float(tr["softness"])
    width, height = int(rcfg["width"]), int(rcfg["height"])
    t0 = time.perf_counter()
    with torch.no_grad():
        cam19 = camera.camera_constants(cam, width, height)
        sums, _ = ref.pixel_sums(tables, rng.fold_in(key, int(tr["target_key"])),
                                 torch.arange(width * height, device=ctx.device), 0,
                                 int(tr["target_spp"]), rcfg, softness, cam19,
                                 chunk_paths=CHUNK_PATHS)
        target = (sums / int(tr["target_spp"])).reshape(height, width, 3).contiguous()
    del sums
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    return dict(tables=tables, scene0=start_scene(tables, tr.get("start", {})), cam=cam,
                cam0=cam, mask=_fit.make_mask(tables, tr.get("mask")), target=target, rcfg=rcfg,
                key=key, softness=softness, camera=False, lr=float(tr["lr"]),
                leaves=tuple(tr["leaves"]), restart_every=_fit.restart_every(tr),
                target_s=target_s)


def measure(ctx):
    tpt, tr = ctx.tpt, ctx.cell.traffic
    inp = inputs(ctx)
    scene0, cam0, mask, target = inp["scene0"], inp["cam0"], inp["mask"], inp["target"]
    key, softness = inp["key"], inp["softness"]
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    p_scene, p_cam = _lit.program_scene(tpt, scene0), prog.camera(tpt, cam0)
    pcfg = prog.render_config(tpt, inp["rcfg"], ctx.overrides.get("flags"))
    every = inp["restart_every"]
    check_step = _fit.CHECK_RESTART * every
    trace_step = check_step + 1
    counter = emit_counter(softness)
    tracer = Tracer() if ctx.trace else None
    st = {"marks": [], "snap": None, "summary": None, "peak_setup": 0, "n": 0,
          "emits": tpt.tracing.counts()[counter], "emitted": []}

    def callback(_, loss, params):
        now = time.perf_counter()
        i = st["n"]
        st["n"] += 1
        emits = tpt.tracing.counts()[counter]
        if i == check_step or (tracer is not None and i == trace_step):
            st["emitted"].append(emits - st["emits"])
        st["emits"] = emits
        if i == check_step:
            st["snap"] = (float(loss),
                          {k: p.grad.detach().clone() for k, p in params.items()},
                          {k: p.detach().clone() for k, p in params.items()})
        if tracer is not None and i == trace_step:
            tracer.annotate_end(_fit.TRACE_MARK)
            st["summary"] = tracer.stop()
        if i == 0:
            st["setup_s"] = clock.process_age() - inp["target_s"]
            if ctx.device.type == "cuda":
                st["peak_setup"] = torch.cuda.max_memory_allocated(ctx.device)
                torch.cuda.reset_peak_memory_stats(ctx.device)
        if tracer is not None and i == trace_step - 1:
            tracer.start()
            tracer.annotate_begin(_fit.TRACE_MARK)
        if i == 0:
            st["marks"].append(time.perf_counter())
            return
        st["marks"].append(now)
        if (now - st["marks"][0] >= ctx.seconds and st["snap"] is not None
                and (tracer is None or st["summary"] is not None)):
            raise _fit.WindowClosed

    kw = dict(steps=every, lr=inp["lr"], callback=callback, softness=softness,
              leaves=inp["leaves"], param_mask=mask, device=ctx.device)
    try:
        for r in range(1 << 30):
            tpt.fit(p_scene, target, p_cam, pcfg, prog.key_tensor(_fit.restart_key(key, r)), **kw)
    except _fit.WindowClosed:
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
        steps=steps, trace=st["summary"], snap=st["snap"], emitted=st["emitted"], **inp,
    )


def reference_steps(run, n_steps: int, dtype=torch.float32, emit: str = "both", spp=None):
    """The reference's first ``n_steps`` steps of the checked restart, from
    the run's start: [(loss, gradients as the optimizer gets them, leaves
    after the step, work)].  ``emit`` and ``spp``: the faults of
    ``control_fit_lit.py`` (the emission term left out of the gradient or
    of both passes; fewer samples)."""
    key = _fit.restart_key(run.key, _fit.CHECK_RESTART)
    leaves = start_leaves(run)
    static = {"scene": run.scene0, "camera": run.cam0}
    rcfg = dict(run.rcfg, spp=int(spp or run.rcfg["spp"]))
    adam = ref.Adam(leaves, run.lr, run.mask)
    out = []
    for s in range(n_steps):
        loss, g, work = ref.loss_and_grad(leaves, static, run.target, rng.fold_in(key, s), rcfg,
                                          run.softness, decoupled=run.softness > 0.0,
                                          dtype=dtype, chunk_paths=CHUNK_PATHS, emit=emit)
        leaves = adam.step(leaves, g)
        out.append((loss, ref.masked(g, run.mask), leaves, work))
    return out


def start_leaves(run) -> dict:
    return {k: run.scene0[k] for k in run.leaves}


def step_work(run, leaves: dict, step: int) -> dict:
    """The work of the checked restart's step ``step`` from ``leaves``,
    counted by the reference's forward passes alone (the value's samples
    and the pulled-back half's, as ``grad_lit.loss_and_grad`` counts
    them)."""
    r = run.rcfg
    spp, p = int(r["spp"]), int(r["width"]) * int(r["height"])
    key = rng.fold_in(_fit.restart_key(run.key, _fit.CHECK_RESTART), step)
    scene = dict(run.scene0, **{k: v.detach() for k, v in leaves.items()})
    cam19 = camera.camera_constants(run.cam0, int(r["width"]), int(r["height"]))
    ids = torch.arange(p, device=run.target.device)
    h = max(spp // 2, 1) if run.softness > 0.0 else spp
    with torch.no_grad():
        _, wa = ref.pixel_sums(scene, key, ids, 0, h, r, run.softness, cam19,
                               chunk_paths=CHUNK_PATHS)
        _, wb = ref.pixel_sums(scene, key, ids, h if h < spp else 0, spp, r, run.softness,
                               cam19, chunk_paths=CHUNK_PATHS)
    return {"segments": wa["segments"] + wb["segments"], "evals": wa["evals"] + wb["evals"],
            "segments_grad": wb["segments"]}


def check(ctx, run):
    t0 = time.perf_counter()
    refs = reference_steps(run, 1)
    print(f"timing: reference step {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if run.trace is not None:
        # The traced step's work: the checked restart one step further.
        run.work = step_work(run, refs[0][2], 1)
        run.live_spheres = int(torch.count_nonzero(forward_lit.live(run.tables)))
    got = _fit.compare(run.snap, refs[0][:3], start_leaves(run),
                       log=lambda m: print(m, file=sys.stderr))
    limits = ctx.cell.workload["limits"]
    out = [(k, float(v), float(limits[k])) for k, v in got.items()]
    if ctx.device.type == "cuda":
        unlit = sum(1 for n in run.emitted if n == 0)
        out.append(("unlit_step_share", unlit / max(1, len(run.emitted)),
                    float(limits["unlit_step_share"])))
    run.failed = int(any(v > lim for _, v, lim in out))
    return out
