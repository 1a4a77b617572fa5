"""The port's command line on the CPU (``--device cpu``), against the JAX
package where a library call of it serves: ``info``, ``render`` (its image
against the JAX ``render`` of the same preset, config and key, within the
knife-edge bound: at most 1 LSB on at most 0.5% of the u8 channels),
snapshot and resume (byte-equal files), both ``invert`` modes at
``tests/test_cli.py``'s shapes (Meter records, artifact), and the CUDA
requirement without ``--device``."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import io as jio
from simplepathtracer_tpu_torch import io
from simplepathtracer_tpu_torch.cli import main

TINY = ["--preset", "simple", "--width", "32", "--height", "16", "--max-depth", "3",
        "--no-pallas", "--device", "cpu"]


def _records(capsys):
    """The Meter's JSON lines written to standard error since the last call."""
    return [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]


def test_info_lists_presets(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "presets" in out and "cover" in out and "devices" in out


def test_render_matches_the_jax_render(tmp_path, capsys):
    out = str(tmp_path / "img.bmp")
    assert main(["render", *TINY, "--spp", "4", "-o", out]) == 0
    recs = _records(capsys)
    assert [r["phase"] for r in recs] == ["render", "done"]
    assert recs[0]["paths"] == 32 * 16 * 4 and recs[0]["paths_per_sec"] > 0
    assert recs[1] == {"phase": "done", "output": out, "spp": 4, "encoder": io.encoder(out)}

    scene, cam, cfg = spt.PRESETS["simple"].build(jax.random.PRNGKey(0))
    cfg = cfg.replace(width=32, height=16, spp=4, max_depth=3, use_pallas=False)
    want = jio.to_u8(np.asarray(spt.render(scene, cam, cfg, jax.random.PRNGKey(0))))
    got = io.read_bmp(out)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape == (16, 32, 3)
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())


def test_render_snapshot_resume_byte_equal(tmp_path):
    out1, out2 = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    snap = str(tmp_path / "s.npz")
    assert main(["render", *TINY, "--spp", "8", "-o", out1, "-q"]) == 0
    assert main(["render", *TINY, "--spp", "4", "-o", str(tmp_path / "partial.bmp"),
                 "--snapshot", snap, "--snapshot-every", "4", "-q"]) == 0
    assert main(["render", "--preset", "simple", "--resume", snap, "--spp", "8", "-o", out2,
                 "--device", "cpu", "-q"]) == 0
    with open(out1, "rb") as a, open(out2, "rb") as b:
        assert a.read() == b.read()


def test_invert_demo(tmp_path, capsys):
    out = str(tmp_path / "rec.png")
    assert main(["invert", "--steps", "3", "--width", "24", "--height", "12", "--spp", "2",
                 "--device", "cpu", "-o", out]) == 0
    recs = _records(capsys)
    assert [r["phase"] for r in recs] == ["invert_albedo", "invert_centers", "invert_done"]
    done = recs[-1]
    assert set(done) == {"phase", "loss_first", "loss_last", "center_err_before",
                         "center_err_after"}
    assert np.isfinite([done["loss_first"], done["loss_last"]]).all()
    assert done["center_err_before"] == pytest.approx(0.1)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_invert_preset(tmp_path, capsys):
    """Preset-scale invert: a hard albedo phase and a soft phase, each with
    its step record, then the summary and the before | target | after
    artifact (three rows of the frame)."""
    out = str(tmp_path / "trip.bmp")
    assert main(["invert", "--preset", "three_sphere", "--steps", "3", "--width", "32",
                 "--height", "16", "--spp", "2", "--max-depth", "3", "--device", "cpu",
                 "-o", out]) == 0
    recs = _records(capsys)
    assert [r["phase"] for r in recs] == [
        "invert_albedo", "invert_albedo_steps", "invert_centers", "invert_centers_steps",
        "invert_done", "artifact"]
    assert recs[1]["steps_run"] == 1 and recs[3]["steps_run"] == 2
    done = recs[4]
    assert done["preset"] == "three_sphere" and done["spp"] == 2 and done["size"] == "32x16"
    assert np.isfinite([done["loss_first"], done["loss_last"]]).all()
    assert io.read_bmp(out).shape == (48, 32, 3)


@pytest.mark.parametrize("cmd", [
    ["render", "--preset", "simple", "--width", "8", "--height", "4", "--spp", "1"],
    ["invert", "--steps", "1", "--width", "8", "--height", "4", "--spp", "1"],
], ids=["render", "invert"])
def test_commands_need_cuda_without_device(cmd, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(cmd)
    assert not os.listdir(tmp_path)
