"""The frozen operation counts, the trace's reduction, and the segments the
reference counts."""

import pytest
import torch

from pb_core import clock, peaks
from pb_core.trace import MARK, summarize


def test_scan_least_time_and_roofline():
    # PERF.md's bound of the cover frame: 2.6e8 segments x 487 spheres x 20
    # operations at 67 TFLOP/s is about 38 ms.
    least = peaks.scan_least_seconds(263_000_000, 487, peaks.FLOPS_HARD_TEST)
    assert least == pytest.approx(263e6 * 487 * 20 / 67e12)
    assert 0.037 < least < 0.039
    assert peaks.scan_least_seconds(10, 3, peaks.FLOPS_SOFT_TEST) == 10 * 3 * 32 / 67e12
    assert peaks.roofline_pct(0.03, 0.12) == pytest.approx(25.0)
    assert peaks.roofline_pct(0.03, 0.0) is None


def test_percentile():
    assert clock.percentile(range(101), 95) == 95
    assert clock.percentile([1.0, 2.0], 50) == 1.5
    assert clock.process_age() > 0


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_trace_summary_busy_gaps_and_counts():
    events = [
        _ev(MARK, "user_annotation", 0, 100),
        _ev("step", "user_annotation", 10, 80),
        _ev("aten::add", "cpu_op", 40, 20),
        _ev("spt::k(int)", "kernel", 10, 20, tid=7),
        _ev("at::native::add", "kernel", 25, 10, tid=7),
        _ev("Memcpy HtoD", "gpu_memcpy", 70, 10, tid=8),
        _ev("outside", "kernel", 200, 10, tid=7),
    ]
    s = summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.count("kernel", *s.marks["step"]) == 2
    assert s.seconds("spt::") == pytest.approx(20e-6)
    gaps = dict((n, round(d * 1e6)) for n, d in s.gaps)
    assert gaps["aten::add"] == 35
    assert sum(d for _, d in s.gaps) == pytest.approx(65e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "spt::k(int)" and len(b["idle_gaps"]) == 3


def test_reference_segments_are_the_program_plain_versions_counts():
    """The segments the reference counts equal the bounce iterations the
    program's plain forward counts, path for path."""
    import simplepathtracer_tpu_torch as tpt
    from simplepathtracer_tpu_torch.ops.persistent import render_block_persistent_reference
    from simplepathtracer_tpu_torch.render import _persistent_args

    from pb_core import program, spec
    from pb_reference import camera, forward, rng, scene

    cover = spec.load_json(spec.BENCH_DIR / "configs" / "cover.json")
    cfg = program.render_block(cover, width=32, height=16, spp=3)
    tables = scene.to_device(scene.make_tables(dict(cover["scene"], seed=9)), "cpu")
    cam = camera.make_camera(cover["camera"], "cpu")
    key = rng.key_from_seed(12345)
    ids = torch.arange(32 * 16)
    _, segs = forward.pixel_sums(tables, camera.camera_constants(cam, 32, 16), key, ids, 0, 3, cfg)
    ps, pc = program.scene(tpt, tables), program.camera(tpt, cam)
    t, sky6, cam19 = _persistent_args(ps, pc, program.render_config(tpt, cfg))
    _, counts = render_block_persistent_reference(
        ids, t, sky6, cam19, program.key_tensor(key), 0, 3, 10, 32, 16, return_counts=True)
    assert segs == int(counts.sum())
