"""Readings that set the comparison's limits of an emitter-lit fit cell: the
control and the faults (``control.py``'s method, for the cells whose
traffic's entry is ``fit_lit``).

    python3 port_bench/control_fit_lit.py --workload <cell> --seeds 11,22,33 [--modes control,half,...]

For each seed this builds the cell's inputs as a run does, puts the
reference (``pb_reference.grad_lit``) in the program's place with one
change, and compares its checked step with the reference's exactly as a run
compares the program's (``pb_drivers.fit.compare``), printing one JSON line
per seed with the compared numbers of the sound reference and of each mode.
Modes:

* ``control``: the reference in bfloat16, the precision below the
  configuration's float32;
* ``half``: half of the samples left out (each decoupled half halved);
* ``no_emit_grad``: the emission term kept in the value but dropped from
  the gradient (an adjoint without the emission's radiance suffix);
* ``no_emit``: the emission term dropped from the value and the gradient;
* ``alter``: the checked step's gradient of the emission 5% larger;
* ``unchanged``: the leaves never move.

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

MODES = ("control", "half", "no_emit_grad", "no_emit", "alter", "unchanged")


def readings(ctx, modes) -> dict:
    import torch

    from pb_drivers import fit as ft, fit_lit as fl

    inp = fl.inputs(ctx)
    run = SimpleNamespace(**inp)
    want = fl.reference_steps(run, 1)[0][:3]
    start = fl.start_leaves(run)
    out = {"sound": ft.compare(want, want, start)}
    for mode in modes:
        if mode == "control":
            got = fl.reference_steps(run, 1, dtype=torch.bfloat16)[0][:3]
        elif mode == "half":
            got = fl.reference_steps(run, 1, spp=int(run.rcfg["spp"]) // 2)[0][:3]
        elif mode == "no_emit_grad":
            got = fl.reference_steps(run, 1, emit="backward")[0][:3]
        elif mode == "no_emit":
            got = fl.reference_steps(run, 1, emit="none")[0][:3]
        elif mode == "alter":
            grads = dict(want[1], emission=want[1]["emission"] * 1.05)
            got = (want[0], grads, want[2])
        elif mode == "unchanged":
            got = (want[0], want[1], dict(start))
        else:
            raise ValueError(f"mode {mode!r} does not apply to this cell")
        out[mode] = ft.compare(got, want, start)
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
