"""One run of one cell: set-up, the measured window, the comparison with the
reference, the metrics, and the result line.

``run_cell`` is the whole of ``run.py`` but the argument parsing and the
printing; tests call it with ``need_chip=False`` to drive a run on the CPU
at a small size.
"""

from __future__ import annotations

import importlib
import math
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

from . import spec


class NoChip(RuntimeError):
    pass


@dataclass
class Context:
    """What a driver is handed: the cell, the run's arguments, the device
    and the program's package (``program.load()``)."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tpt: object
    overrides: dict = field(default_factory=dict)


def check_chips(chips: int):
    """Raises ``NoChip`` unless CUDA is there with ``chips`` devices."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: this benchmark runs only on a GPU")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell needs {chips} GPUs, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def device_info(torch, count: int, peak_bytes: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak_bytes)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, need_chip: bool = True,
             bench: dict | None = None, cell: spec.Cell | None = None, device=None,
             overrides: dict | None = None, bench_dir=spec.BENCH_DIR):
    """Run one cell once; returns (result dict, [(check name, value, limit)]).

    ``bench_dir`` is where the cell's and metrics' files are found."""
    cell = cell or spec.load_cell(name, bench_dir)
    bench = bench if bench is not None else spec.benchmark()
    if need_chip:
        check_chips(cell.chips)
    import torch

    from . import program

    tpt = program.load()
    dev = torch.device(device or "cuda")
    drv = importlib.import_module(f"pb_drivers.{cell.traffic['entry']}")
    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=dev, tpt=tpt, overrides=dict(overrides or {}))
    t0 = time.perf_counter()
    run = drv.measure(ctx)
    t1 = time.perf_counter()
    checks = drv.check(ctx, run)
    print(f"timing: set-up and window {t1 - t0:.3f} s, comparison {time.perf_counter() - t1:.3f} s",
          file=sys.stderr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, name, kind):
        value = spec.metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {
        "correct": bool(correct),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": dict(device_info(torch, cell.chips, run.peak_bytes),
                       **({"busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
                          if trace and getattr(run, "trace", None) else {})),
    }
    if trace and getattr(run, "trace", None) is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def new_run(**kw) -> SimpleNamespace:
    """What a driver's ``measure`` returns: ``attempted``, ``failed``,
    ``peak_bytes``, ``setup_s``, ``window_s``, ``trace`` and whatever its
    metric readers and ``check`` read."""
    base = dict(attempted=0, failed=0, peak_bytes=0, setup_s=None, window_s=None, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def forbidden_or_exit():
    """Names loaded modules of JAX or the JAX package on standard error and
    exits with 3 if there are any."""
    from .program import forbidden_modules

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the reporting process: {bad}", file=sys.stderr)
        sys.exit(3)
