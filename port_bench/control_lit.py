"""Readings that set the comparison's limit of an emitter-lit render cell:
the control and the faults (``control.py``'s method, for the cells whose
traffic's entry is ``render_lit``).

    python3 port_bench/control_lit.py --workload <cell> --seeds 11,22,33 [--modes control,half,...]

For each seed this builds the cell's inputs as a run does, puts the
reference (``pb_reference.forward_lit``) in the program's place with one
change, and compares what it produces with the reference exactly as a run
compares the program's output, printing one JSON line per seed with the
``flip_share`` of each mode.  Modes:

* ``control``: the reference in bfloat16, the precision below the
  configuration's float32;
* ``half``: half of the samples left out, the mean taken over the rest;
* ``stale``: each checked frame is the frame before it;
* ``alter``: every pixel of a frame 1e-3 brighter;
* ``no_emission``: the emission term dropped (the scene lit by its sky
  alone).

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

MODES = ("control", "half", "stale", "alter", "no_emission")


def readings(ctx, modes, n_frames: int = 200) -> dict:
    import torch

    from pb_drivers import render_lit as rl

    tables, cam, rcfg, key = rl.inputs(ctx)
    n_pix = int(rcfg["width"]) * int(rcfg["height"])
    pix = rl.check_pixels(ctx, n_pix, min(int(ctx.cell.traffic["check_pixels"]), n_pix))
    run = SimpleNamespace(tables=tables, cam=cam, rcfg=rcfg, key=key, pix=pix, n_pix=n_pix)
    frames = rl.checked_frames(ctx, n_frames)
    refs = {f: rl.reference_image(run, f) for f in frames}
    out = {}
    for mode in modes:
        off = tot = 0
        for f in frames:
            if mode == "control":
                img = rl.reference_image(run, f, dtype=torch.bfloat16)
            elif mode == "half":
                img = rl.reference_image(run, f, spp=int(rcfg["spp"]) // 2)
            elif mode == "stale":
                img = rl.reference_image(run, f - 1 if f else f + 1)
            elif mode == "alter":
                img = refs[f] + 1e-3
            elif mode == "no_emission":
                img = rl.reference_image(run, f, emit=False)
            else:
                raise ValueError(f"mode {mode!r} does not apply to this cell")
            o, n = rl.flip_share(img, refs[f])
            off, tot = off + o, tot + n
        out[mode] = {"flip_share": off / tot}
    return out


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
    modes = [m for m in args.modes.split(",") if m] or list(MODES)
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=torch.device(args.device), tpt=None)
        t0 = time.perf_counter()
        got = readings(ctx, modes)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
