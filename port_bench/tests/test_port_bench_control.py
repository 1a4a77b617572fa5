"""The comparison that decides ``correct``, shown to fail: the control (the
reference in bfloat16 in the program's place) and every fault a cell can
have make a run come out not correct, while a sound run is correct.

Sizes a test can hold, on the CPU: the cells' own files at 48 x 24 pixels,
the program on the plain versions of its GPU routes' kernels.  The control
and the faults at the cells' own sizes run on the GPU (``cuda`` tests,
and ``control.py``, whose readings PERF.md keeps)."""

import json
import subprocess
import sys

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import inverse

import bench_small
import control
from pb_core import harness, spec

RENDER_CELLS = ["cover.render"]
FIT_CELLS = ["cover.fit_soft", "cover.fit_camera"]


def _ctx(cell, seed):
    return harness.Context(cell=spec.load_cell(cell), seed=seed, seconds=0.0, trace=False,
                           device=torch.device("cpu"), tpt=None,
                           overrides=bench_small.overrides(cell))


@pytest.mark.parametrize("cell", RENDER_CELLS + FIT_CELLS)
def test_a_sound_run_is_correct(cell):
    res, checks = bench_small.run(cell, 11)
    assert res["correct"], checks
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("trace", [False, True])
def test_traced_runs_mean_the_same(trace):
    res, _ = bench_small.run("cover.fit_soft", 12, trace=trace)
    assert res["correct"]
    assert ("busy_s" in res["device"]) == trace


def _limits(cell):
    return spec.load_cell(cell).workload["limits"]


@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_render_control_and_faults_fail(cell):
    got = control.render_readings(_ctx(cell, 21), list(control.RENDER_MODES), n_frames=3)
    lim = _limits(cell)["flip_share"]
    for mode, r in got.items():
        assert r["flip_share"] > lim, (mode, r)


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_control_and_faults_fail(cell):
    got = control.fit_readings(_ctx(cell, 22), list(control.FIT_MODES))
    lim = _limits(cell)
    assert all(v <= lim[k] for k, v in got.pop("sound").items())
    for mode, r in got.items():
        assert any(v > lim[k] for k, v in r.items()), (mode, r)


# Faults planted in the program's timed path: each run must come out not
# correct.


def _stale(monkeypatch):
    orig, first = tpt.render, {}

    def render(*a, **k):
        if "img" not in first:
            first["img"] = orig(*a, **k)
        return first["img"].clone()

    monkeypatch.setattr(tpt, "render", render)


def _half_render(monkeypatch):
    orig = tpt.render
    monkeypatch.setattr(tpt, "render",
                        lambda s, c, cfg, k: orig(s, c, cfg.replace(spp=cfg.spp // 2), k))


def _alter_render(monkeypatch):
    orig = tpt.render
    monkeypatch.setattr(tpt, "render", lambda *a: orig(*a) + 1e-3)


@pytest.mark.parametrize("fault", [_stale, _half_render, _alter_render],
                         ids=["unchanged", "half", "alter"])
def test_render_faults_make_a_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res, checks = bench_small.run("cover.render", 31)
    assert not res["correct"], checks


def _no_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_loss(monkeypatch):
    for name in ("pixel_loss_decoupled", "camera_pixel_loss"):
        orig = getattr(inverse, name)

        def half(*a, _orig=orig, **k):
            a = list(a)
            a[4] = a[4].replace(spp=a[4].spp // 2)   # the config, in both losses
            return _orig(*a, **k)

        monkeypatch.setattr(inverse, name, half)


def _alter_loss(monkeypatch):
    for name in ("pixel_loss_decoupled", "camera_pixel_loss"):
        orig = getattr(inverse, name)
        monkeypatch.setattr(inverse, name, lambda *a, _o=orig, **k: _o(*a, **k) * 1.05)


@pytest.mark.parametrize("cell", FIT_CELLS)
@pytest.mark.parametrize("fault", [_no_step, _half_loss, _alter_loss],
                         ids=["unchanged", "half", "alter"])
def test_fit_faults_make_a_run_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    res, checks = bench_small.run(cell, 32)
    assert not res["correct"], checks


def break_exchange():
    """Rank set-up of the sharded fault: the gather keeps each rank's own
    rows and exchanges nothing."""
    from simplepathtracer_tpu_torch.parallel import sharding

    sharding._all_reduce = lambda t, mesh, dim: t


def test_sharded_run_without_the_exchange_is_incorrect():
    res, checks = bench_small.run("cover_multihost.render_4gpu", 33, rank_setup=break_exchange)
    assert not res["correct"], checks


def test_sharded_sound_run_is_correct():
    res, checks = bench_small.run("cover_multihost.render_4gpu", 34)
    assert res["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", RENDER_CELLS + FIT_CELLS + ["cover_multihost.render_4gpu"])
def test_control_at_the_cell_size_fails_on_the_gpu(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU: the control at the cell's own size")
    out = subprocess.run([sys.executable, str(spec.BENCH_DIR / "control.py"), "--workload", cell,
                          "--seeds", "101,202,303", "--modes", "control"],
                         capture_output=True, text=True, timeout=3000, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    lim = _limits(cell)
    for line in out.stdout.splitlines():
        r = json.loads(line)["readings"]["control"]
        assert any(v > lim[k] for k, v in r.items()), r
