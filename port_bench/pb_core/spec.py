"""Finding a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics; a
cell ``<name>`` has ``workloads/<name>.json`` (its configuration and
traffic by name), the configuration ``configs/<config>.json``, the traffic
``traffic/<traffic>.json`` (whose ``entry`` names the driver,
``pb_drivers/<entry>.py``) and each metric a reader ``metrics/<metric>.py``.
A later cell, mix or metric is a new file of its own: nothing here lists
them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    workload: dict


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell's workload, configuration and traffic files, by name."""
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    cfg = load_json(bench_dir / "configs" / f"{wl['config']}.json")
    tr = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    return Cell(name=name, config=cfg, traffic=tr, chips=int(wl.get("chips", 1)), workload=wl)


def metrics_for(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports.  A metric with ``workloads`` lists its cells; an end-to-end
    metric without it is every cell's; a per-layer one without it is every
    cell's that reports the end-to-end metric it ``moves``."""
    e2e_names = {m["name"] for m in metrics_for(bench, cell, "end_to_end")} \
        if kind == "per_layer" else set()
    out = []
    for m in bench.get(kind, []):
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in e2e_names:
            out.append(m)
    return out


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read(run)``: the metric's value, or None
    where the run holds nothing to read."""
    return load_module(bench_dir / "metrics" / f"{name}.py", f"pb_metric_{name}").read
