"""BENCHMARK.json against the benchmark's contract, and every file of a cell
found by its name; a cell, mix, configuration or metric added as files runs
with no code edited."""

import json
import re
import shutil

import pytest

from pb_core import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    n4 = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert n4 <= max(1, len(BENCH["workloads"]) // 4)


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 1 <= len(x) <= 200 for x in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c = spec.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == w["config"] and c.workload["traffic"] == w["traffic"]
    assert c.chips == w["chips"]
    assert (spec.BENCH_DIR / "pb_drivers" / f"{c.traffic['entry']}.py").is_file()
    e2e = [m["name"] for m in spec.metrics_for(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, "per_layer")
    assert set(c.workload["limits"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = spec.ROOT / cfg["file"]
    assert path.is_relative_to(spec.BENCH_DIR)
    data = spec.load_json(path)
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for k in cfg["reduced"]:
        assert k in data and k in data["assumed"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_load_by_name(metric):
    read = spec.metric_reader(metric["name"])
    assert callable(read)
    if metric in BENCH["per_layer"]:
        assert any(metric["moves"] == m["name"] for m in BENCH["end_to_end"])


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration, mix, cell and metric are files alone: the harness
    finds and runs them with no edit to its code."""
    from bench_small import overrides
    from pb_core import harness

    bench_dir = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub)
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "cover.json")
    cfg.update(width=32, height=16, spp=2)
    (bench_dir / "configs" / "cover_small.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "render_few.json").write_text(json.dumps(
        {"entry": "render", "check_pixels": 64}))
    (bench_dir / "workloads" / "cover_small.render_few.json").write_text(json.dumps(
        {"config": "cover_small", "traffic": "render_few", "chips": 1,
         "limits": {"flip_share": 0.0}}))
    (bench_dir / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    bench = json.loads(json.dumps(BENCH))
    name = "cover_small.render_few"
    bench["workloads"].append({"name": name, "config": "cover_small", "traffic": "render_few",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_mpaths_s":
            m["workloads"].append(name)
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": [name]})
    res, checks = harness.run_cell(name, 5, 0.1, False, need_chip=False, device="cpu",
                                   bench=bench, bench_dir=bench_dir,
                                   overrides={k: v for k, v in overrides(name).items()
                                              if k != "render"})
    assert res["correct"] and checks == [("flip_share", 0.0, 0.0)]
    assert set(res["metrics"]) == {"render_mpaths_s", "setup_s", "frames_done"}
    assert res["metrics"]["frames_done"]["value"] == res["attempted"] >= 1
