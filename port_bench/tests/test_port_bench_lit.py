"""The emitter-lit cell (``render_lit`` traffic, ``smallpt`` configuration):
a sound run at a small size on the CPU, its faults (emission dropped among
them) and control, the reference's counts of a tiny frame checked by hand,
the lit roofline's arithmetic, and a program whose ``Scene`` has no
emission failing before set-up."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

import simplepathtracer_tpu_torch as tpt

import bench_small
import control_lit
from pb_core import harness, peaks, peaks_lit, program, spec
from pb_drivers import render_lit
from pb_reference import camera, forward_lit, rng

CELL = "smallpt.render_lit"


def _ctx(seed):
    return harness.Context(cell=spec.load_cell(CELL), seed=seed, seconds=0.0, trace=False,
                           device=torch.device("cpu"), tpt=None,
                           overrides=bench_small.overrides(CELL))


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    res, checks = bench_small.run(CELL, 2**33 + 41, trace=trace)
    assert res["correct"], checks
    assert [c[0] for c in checks] == ["flip_share"]
    assert {"render_mpaths_s", "setup_s"} <= set(res["metrics"]) or trace
    assert ("busy_s" in res["device"]) == trace


def test_control_and_faults_fail():
    got = control_lit.readings(_ctx(3_000_000_019), list(control_lit.MODES), n_frames=3)
    lim = spec.load_cell(CELL).workload["limits"]["flip_share"]
    for mode, r in got.items():
        assert r["flip_share"] > 10 * lim, (mode, r)


def _no_emission(monkeypatch):
    orig = tpt.render
    monkeypatch.setattr(tpt, "render", lambda s, *a: orig(s.replace(emission=None), *a))


def _half(monkeypatch):
    orig = tpt.render
    monkeypatch.setattr(tpt, "render",
                        lambda s, c, cfg, k: orig(s, c, cfg.replace(spp=cfg.spp // 2), k))


@pytest.mark.parametrize("fault", [_no_emission, _half], ids=["no_emission", "half"])
def test_faults_make_a_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res, checks = bench_small.run(CELL, 77)
    assert not res["correct"], checks


def test_a_program_without_emission_cannot_run_the_cell():
    @dataclasses.dataclass(frozen=True)
    class Scene:
        centers: object

    with pytest.raises(program.ProgramMissing, match="emission"):
        render_lit.program_scene(SimpleNamespace(Scene=Scene), {})


def _tiny(cfg_over, spheres, sky=0.0):
    scene = {"spheres": spheres, "sky_lo": [sky] * 3, "sky_hi": [sky] * 3}
    tables = forward_lit.lit_tables(scene, "cpu")
    cam = camera.make_camera({"origin": [0.0, 0.0, 0.0], "lookat": [0.0, 0.0, -1.0],
                              "vup": [0.0, 1.0, 0.0], "vfov_deg": 60.0, "aperture": 0.0}, "cpu")
    cfg = dict({"width": 4, "height": 3, "spp": 2, "max_depth": 3, "t_min": 1e-3,
                "t_max": 3e7, "rr_start_depth": 0}, **cfg_over)
    cam19 = camera.camera_constants(cam, cfg["width"], cfg["height"])
    return forward_lit.pixel_sums(tables, cam19, rng.key_from_seed(5), torch.arange(12), 0,
                                  cfg["spp"], cfg)


def _shell(albedo=0.5, emission=1.0):
    """A Lambertian sphere of radius 10 around the camera: every segment hits."""
    return {"center": [0.0, 0.0, 0.0], "radius": 10.0, "albedo": [albedo] * 3,
            "material": "lambertian", "fuzz": 0.0, "ior": 1.5, "emission": [emission] * 3}


def test_reference_counts_of_a_tiny_frame_by_hand():
    # 12 pixels x 2 samples = 24 paths inside a shell: 3 segments each, all
    # hits: 24 x 3 segments, 24 x (2 + 3 x 3) evaluations; each path's
    # radiance 1 + 0.5 + 0.25 (the throughput before each hit's attenuation).
    sums, work = _tiny({}, [_shell()])
    assert work == {"segments": 72, "evals": 24 * 11, "roulette": 0, "self_hits": 0}
    assert torch.equal(sums, torch.full((12, 3), 2 * 1.75))
    # Roulette from bounce 1 at depth 3: a draw for every path at bounce 1
    # (bounce 2 is the last, where no path scatters on), and the survivors'
    # third segment.
    _, work = _tiny({"rr_start_depth": 1}, [_shell()])
    survivors = work["segments"] - 48
    assert work["roulette"] == 24 and 0 <= survivors <= 24
    assert work["evals"] == 24 * 2 + 3 * work["segments"] + 24
    # Nothing to hit: one segment a path, the camera's 2 evaluations, the sky.
    behind = dict(_shell(), center=[0.0, 0.0, 50.0], radius=1.0)
    sums, work = _tiny({}, [behind], sky=0.25)
    assert work == {"segments": 24, "evals": 48, "roulette": 0, "self_hits": 0}
    assert torch.equal(sums, torch.full((12, 3), 0.5))


def test_lit_roofline_arithmetic():
    assert peaks_lit.CLOCK_HZ == pytest.approx(1.9827e9, rel=1e-4)
    assert peaks_lit.PEAK_INT32 == pytest.approx(16.75e12)
    assert peaks_lit.rng_least_seconds(10**9) == pytest.approx(73e9 / 16.75e12)
    # 1.3e9 segments over 8 spheres: the scan 3.1 ms; 4.6e9 evaluations:
    # the RNG 20.1 ms, the larger.
    scan = peaks.scan_least_seconds(1_300_000_000, 8, 20)
    assert scan == pytest.approx(1.3e9 * 160 / 67e12)
    least = peaks_lit.lit_least_seconds(1_300_000_000, 8, 4_600_000_000)
    assert least == pytest.approx(4.6e9 * 73 / 16.75e12) and least > scan
    assert peaks_lit.lit_least_seconds(10**9, 488, 10) == pytest.approx(1e9 * 488 * 20 / 67e12)


def test_lit_roofline_reads_nothing_without_the_work():
    read = spec.metric_reader("persistent_lit_roofline")
    assert read(SimpleNamespace(trace=None)) is None
    assert read(SimpleNamespace(trace=object(), lit_work=None)) is None
