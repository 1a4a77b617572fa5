"""The port's tracing (``simplepathtracer_tpu_torch/tracing.py``) on the CPU:
spans are no-ops while tracing is off; on, the render, the soft regen fit
step (the regen route's plain versions) and the camera fit step give the
layers' span tree; periods, the record bound, the counters under threads,
the profiler's clock, the CLI's ``spans.json``, and the two ``port_bench``
readers that read the spans.  One ``cuda`` case holds the regen forward's
work-queue counts on the card.  This file imports no JAX, so the ``cuda``
case also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda
"""

import json
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import metrics, tracing
from simplepathtracer_tpu_torch.cli import main

BENCH = Path(__file__).resolve().parent.parent / "port_bench"


def _scene_cam():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    return scene, cam


RENDER_CFG = tpt.RenderConfig(width=8, height=4, spp=4, max_depth=3, use_pallas=True,
                              spp_chunk=2)
# The regen route's plain versions, streamed in 1-spp chunks.
REGEN_CFG = tpt.RenderConfig(width=8, height=4, spp=4, max_depth=3, use_pallas_grad=True,
                             grad_regen=True, spp_chunk=1)
FUSED_CFG = tpt.RenderConfig(width=8, height=4, spp=4, max_depth=3, use_pallas_grad=True)
TARGET = torch.zeros((4, 8, 3))


def _soft_fit_step():
    scene, cam = _scene_cam()
    tpt.fit(scene, TARGET, cam, REGEN_CFG, tpt.make_key(0), steps=1, device="cpu")


def _camera_fit_step():
    scene, cam = _scene_cam()
    tpt.fit_camera(scene, TARGET, cam, FUSED_CFG, tpt.make_key(0), steps=1, device="cpu")


def _tree(recs):
    """[(name, parent's name)] in opening order, and the request ids."""
    by_id = {r["id"]: r["name"] for r in recs}
    return [(r["name"], by_id.get(r["parent"])) for r in recs], {r["request"] for r in recs}


def test_span_off_is_the_shared_noop():
    with tracing.enabled():
        pass
    a, b = tracing.span("spt.test.a"), tracing.span("spt.test.b", n=1)
    assert a is b
    with a as sp:
        sp.add("n", 1)
        tracing.add("n", torch.ones(3))
    scene, cam = _scene_cam()
    tpt.render(scene, cam, RENDER_CFG, tpt.make_key(0))
    assert tracing.spans() == []


def test_render_span_tree():
    scene, cam = _scene_cam()
    with tracing.enabled():
        tpt.render(scene, cam, RENDER_CFG, tpt.make_key(0))
    recs = tracing.spans()
    tree, requests = _tree(recs)
    assert tree == [("spt.render", None), ("spt.accumulate", "spt.render"),
                    ("spt.accumulate.chunk", "spt.accumulate"),
                    ("spt.accumulate.chunk", "spt.accumulate")]
    assert requests == {recs[0]["id"]}
    assert recs[1]["counts"] == {"spp": 4} and recs[2]["counts"] == {"spp": 2}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] > 0
        assert r["device_ms"] == pytest.approx((r["end_ns"] - r["start_ns"]) * 1e-6)


def test_balanced_accumulate_spans_probe_and_rest():
    scene, cam = _scene_cam()
    cfg = RENDER_CFG.replace(spp_chunk=0, balance_probe_spp=1)
    with tracing.enabled():
        tpt.accumulate(tpt.init_state(cfg, tpt.make_key(0), device="cpu"), scene, cam, cfg, 4)
    recs = tracing.spans()
    assert _tree(recs)[0] == [("spt.accumulate", None), ("spt.accumulate.chunk", "spt.accumulate"),
                              ("spt.accumulate.chunk", "spt.accumulate")]
    assert [r["counts"]["spp"] for r in recs] == [4, 1, 3]


def test_soft_regen_fit_step_span_tree():
    before = tracing.counts()
    with tracing.enabled():
        _soft_fit_step()
    recs = tracing.spans()
    tree, requests = _tree(recs)
    # The decoupled loss: a value pass and a differentiated pass, each one
    # idx-only forward over its 2 chunks; the backward replays the
    # differentiated pass's 2 chunks.
    assert tree == [
        ("spt.fit.step", None), ("spt.fit.loss", "spt.fit.step"),
        ("spt.regen.forward", "spt.fit.loss"), ("spt.regen.forward", "spt.fit.loss"),
        ("spt.fit.backward", "spt.fit.step"),
        ("spt.regen.replay", "spt.fit.backward"), ("spt.regen.replay", "spt.fit.backward"),
        ("spt.fit.update", "spt.fit.step"), ("spt.fit.sync", "spt.fit.step"),
    ]
    # The step's span names the start scene's emitters (none here).
    assert requests == {recs[0]["id"]} and recs[0]["counts"] == {"step": 0, "emitters": 0}
    # The plain versions count live lane iterations but have no thread slots.
    for r in recs[2:4]:
        assert r["counts"]["live_iters"] > 0 and "thread_iters" not in r["counts"]
    got = tracing.counts() - before
    assert got["plain.regen_fwd_reference"] == 4 and got["plain.regen_refwd_reference"] == 2
    assert not [k for k in got if k.startswith("launch.")]


def test_camera_fit_step_span_tree():
    with tracing.enabled():
        _camera_fit_step()
    recs = tracing.spans()
    tree, requests = _tree(recs)
    # The decoupled camera loss renders two halves of the samples.
    assert tree == [
        ("spt.fit.step", None), ("spt.fit.loss", "spt.fit.step"),
        ("spt.rays.camera", "spt.fit.loss"), ("spt.fused.forward", "spt.fit.loss"),
        ("spt.rays.camera", "spt.fit.loss"), ("spt.fused.forward", "spt.fit.loss"),
        ("spt.fit.backward", "spt.fit.step"), ("spt.fused.backward", "spt.fit.backward"),
        ("spt.fit.update", "spt.fit.step"), ("spt.fit.sync", "spt.fit.step"),
    ]
    assert requests == {recs[0]["id"]}


def test_a_new_period_clears_the_last():
    with tracing.enabled():
        with tracing.span("spt.test.a"):
            pass
    assert [r["name"] for r in tracing.spans()] == ["spt.test.a"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("spt.test.b"):
            pass
    assert [r["name"] for r in tracing.spans()] == ["spt.test.b"]
    with tracing.enabled():
        with tracing.span("spt.test.c"):
            pass
    assert [r["name"] for r in tracing.spans()] == ["spt.test.c"]


def test_record_bound_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    before = tracing.counts()["tracing.dropped"]
    with tracing.enabled():
        with tracing.span("spt.test.outer"):
            for _ in range(4):
                with tracing.span("spt.test.inner"):
                    pass
    recs = tracing.spans()
    assert [r["name"] for r in recs] == ["spt.test.outer"] + ["spt.test.inner"] * 2
    assert all(r["parent"] == recs[0]["id"] for r in recs[1:])
    assert tracing.counts()["tracing.dropped"] == before + 2


def test_a_thread_with_no_open_span_takes_the_caller_as_parent():
    """Autograd's backward thread opens spans with none of its own open:
    their parent is the span that called ``backward()``."""
    done = []

    def worker():
        with tracing.span("spt.test.worker"):
            with tracing.span("spt.test.worker_inner"):
                done.append(True)

    with tracing.enabled():
        with tracing.span("spt.test.caller"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and done
    caller, w, inner = tracing.spans()
    assert w["parent"] == caller["id"] and inner["parent"] == w["id"]
    assert caller["request"] == w["request"] == inner["request"] == caller["id"]


def test_counters_lose_no_update_under_threads():
    n_threads, n_each = 16, 2000
    before = tracing.counts()["spt.test.count"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("spt.test.count")
                                                    for _ in range(n_each)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.counts()["spt.test.count"] == before + n_threads * n_each


def test_records_lie_inside_their_profiler_events(tmp_path):
    """``profiler_trace`` writes ``spans.json`` beside ``trace.json``; on the
    CPU each record lies inside its ``record_function`` event within 0.1 ms,
    so the two share one clock."""
    scene, cam = _scene_cam()
    with metrics.profiler_trace(str(tmp_path)):
        tpt.render(scene, cam, RENDER_CFG, tpt.make_key(0))
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    with open(tmp_path / "spans.json") as f:
        exported = json.load(f)
    recs = exported["spans"]
    assert [r["name"] for r in recs] == [r["name"] for r in tracing.spans()]
    assert exported["counts"] == {"plain.render_block_persistent_reference": 2}
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("spt.")]
    assert len(events) == len(recs) == 4
    for r in recs:
        a, b = r["start_ns"] / 1e3, r["end_ns"] / 1e3
        assert any(e["name"] == r["name"] and base_us + e["ts"] - 100 <= a
                   and b <= base_us + e["ts"] + e["dur"] + 100 for e in events), r


def test_cli_render_trace_writes_spans(tmp_path, capsys):
    out, logdir = str(tmp_path / "img.bmp"), tmp_path / "trace"
    assert main(["render", "--preset", "simple", "--width", "16", "--height", "8",
                 "--max-depth", "3", "--spp", "2", "--device", "cpu", "-q", "-o", out,
                 "--trace", str(logdir)]) == 0
    assert (logdir / "trace.json").is_file()
    with open(logdir / "spans.json") as f:
        recs = json.load(f)["spans"]
    tree, requests = _tree(recs)
    assert tree == [("spt.cli.render", None), ("spt.accumulate", "spt.cli.render"),
                    ("spt.accumulate.chunk", "spt.accumulate")]
    assert requests == {recs[0]["id"]}


def _reader(name):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from pb_core import spec

    return spec.metric_reader(name, BENCH)


def test_port_bench_span_readers_on_a_traced_cpu_fit():
    traced, untraced = SimpleNamespace(trace=object()), SimpleNamespace(trace=None)
    camera, lanes = _reader("camera_rays_pct.fit"), _reader("regen_lane_use_pct.fit")
    with tracing.enabled():
        _camera_fit_step()
    assert 0.0 < camera(traced) < 100.0
    assert camera(untraced) is None and lanes(traced) is None
    with tracing.enabled():
        _soft_fit_step()
    assert lanes(traced) is None and camera(traced) is None


@pytest.mark.cuda
def test_regen_forward_span_counts_on_card():
    """The idx-only forward's span keeps each launch's work queue and the
    lanes' summed counts: positive device time, the live iterations within
    the thread-iterations, whole warps of thread slots, every lane
    fetched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.three_sphere_scene(device="cuda")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cuda")
    cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=10, use_pallas_grad=True,
                           grad_regen=True, spp_chunk=2, silhouette_softness=0.05)
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
    target = torch.zeros((24, 48, 3), device="cuda")
    before = tracing.counts()
    with tracing.enabled():
        with tracing.span("spt.test.step"):
            loss = tpt.pixel_loss(params, scene, target, cam, cfg, tpt.make_key(1),
                                  device="cuda")
            loss.backward()
    recs = tracing.spans()
    fwd = [r for r in recs if r["name"] == "spt.regen.forward"]
    assert len(fwd) == 1 and all(r["device_ms"] > 0 for r in recs)
    c = fwd[0]["counts"]
    assert 0 < c["live_iters"] <= c["thread_iters"] and c["thread_iters"] % 32 == 0
    assert c["lanes_fetched"] >= 4 * 48 * 24 and c["blocks"] >= 4
    assert (tracing.counts() - before)["launch.regen_forward.soft"] == 4
