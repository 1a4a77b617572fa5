"""Readings that set the comparison's limits: the control and the faults.

    python3 port_bench/control.py --workload <cell> --seeds 11,22,33 [--modes control,half,...]

For each seed this builds the cell's inputs as a run does, puts the
reference in the program's place with one change, and compares what it
produces with the reference exactly as a run compares the program's output,
printing one JSON line per seed and mode with the compared numbers.  Modes:

* ``control``: the reference in bfloat16, the precision below the
  configuration's float32;
* ``half``: half of the samples left out, the mean taken over the rest;
* ``stale`` (render cells): each checked frame is the frame before it;
* ``alter``: an answer altered where it is produced (render cells: every
  pixel of a frame 1e-3 brighter; fit cells: the checked step's gradient of
  the albedo 5% larger);
* ``unchanged`` (fit cells): the leaves never move;
* ``no_exchange`` (sharded cells): the gather left out, so rank 0 holds its
  own band of rows alone.

The benchmark's runs never run this; its readings are kept in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

RENDER_MODES = ("control", "half", "stale", "alter")
FIT_MODES = ("control", "half", "alter", "unchanged")


def render_readings(ctx, modes, n_frames: int = 200):
    import torch

    from pb_drivers import render as rd

    tables, cam, rcfg, key = rd.inputs(ctx)
    n_pix = int(rcfg["width"]) * int(rcfg["height"])
    pix = rd.check_pixels(ctx, n_pix, min(int(ctx.cell.traffic["check_pixels"]), n_pix))
    base = dict(tables=tables, cam=cam, rcfg=rcfg, key=key, pix=pix, n_pix=n_pix)
    frames = rd.checked_frames(ctx, n_frames)
    refs = {f: rd.reference_image(_ns(base), f) for f in frames}
    out = {}
    for mode in modes:
        off = tot = 0
        for f in frames:
            if mode == "control":
                img = rd.reference_image(_ns(base), f, dtype=torch.bfloat16)
            elif mode == "half":
                half = dict(base, rcfg=dict(rcfg, spp=int(rcfg["spp"]) // 2))
                img = rd.reference_image(_ns(half), f)
            elif mode == "stale":
                img = rd.reference_image(_ns(base), f - 1 if f else f + 1)
            elif mode == "alter":
                img = refs[f] + 1e-3
            elif mode == "no_exchange":
                band = n_pix // int(ctx.cell.config["mesh"]["tiles"])
                img = torch.where((pix < band)[:, None], refs[f], torch.zeros_like(refs[f]))
            else:
                raise ValueError(f"mode {mode!r} does not apply to this cell")
            o, n = rd.flip_share(img, refs[f])
            off, tot = off + o, tot + n
        out[mode] = {"flip_share": off / tot}
    return out


def fit_readings(ctx, modes):
    import torch

    from pb_drivers import fit as ft

    inp = ft.inputs(ctx)
    run = _ns(inp)
    want = ft.reference_steps(run, 1)[0][:3]
    start = ft.start_leaves(run)
    out = {"sound": ft.compare(want, want, start)}
    for mode in modes:
        if mode == "control":
            got = ft.reference_steps(run, 1, dtype=torch.bfloat16)[0][:3]
        elif mode == "half":
            half = _ns(dict(inp, rcfg=dict(inp["rcfg"], spp=int(inp["rcfg"]["spp"]) // 2)))
            got = ft.reference_steps(half, 1)[0][:3]
        elif mode == "alter":
            grads = dict(want[1])
            leaf = "albedo" if "albedo" in grads else next(iter(grads))
            grads[leaf] = grads[leaf] * 1.05
            got = (want[0], grads, want[2])
        elif mode == "unchanged":
            got = (want[0], want[1], dict(start))
        else:
            raise ValueError(f"mode {mode!r} does not apply to this cell")
        out[mode] = ft.compare(got, want, start)
    return out


def _ns(d):
    return SimpleNamespace(**d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from pb_core import harness, spec

    cell = spec.load_cell(args.workload)
    entry = cell.traffic["entry"]
    fit = entry in ("fit", "fit_camera")
    modes = [m for m in args.modes.split(",") if m] or list(
        FIT_MODES if fit else RENDER_MODES + (("no_exchange",) if "mesh" in cell.config else ()))
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=torch.device(args.device), tpt=None)
        t0 = time.perf_counter()
        got = fit_readings(ctx, modes) if fit else render_readings(ctx, modes)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
