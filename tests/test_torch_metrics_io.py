"""The port's ``metrics``, ``native`` and ``io`` on the CPU: the Meter's
records carry the JAX ``Meter``'s keys, ``profiler_trace`` writes a Chrome
trace, ``read_bmp`` and ``default_filename`` give the JAX functions'
results, and the native and pure-Python encoders write byte-equal BMPs and
PNGs that decode to the same pixels."""

import io as pyio
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from simplepathtracer_tpu import io as jio
from simplepathtracer_tpu import metrics as jmetrics
from simplepathtracer_tpu.types import RenderConfig as JaxRenderConfig
from simplepathtracer_tpu_torch import io, metrics, native
from simplepathtracer_tpu_torch.types import RenderConfig


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_meter_records_have_the_jax_keys():
    records = []
    for mod in (metrics, jmetrics):
        stream = pyio.StringIO()
        meter = mod.Meter(stream=stream)
        with meter.phase("render", paths=1000, bounces=10):
            pass
        with meter.phase("idle"):
            pass
        meter.emit({"phase": "done", "spp": 4})
        lines = [json.loads(x) for x in stream.getvalue().splitlines()]
        assert lines == meter.records
        records.append(lines)
    port, jax_records = records
    assert [set(r) for r in port] == [set(r) for r in jax_records]
    assert set(port[0]) == {"phase", "elapsed_s", "paths", "paths_per_sec",
                            "ray_segments_per_sec"}
    assert not metrics.Meter(enabled=False, stream=pyio.StringIO()).stream.getvalue()


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with metrics.profiler_trace(logdir) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
    with metrics.profiler_trace(None) as prof:
        assert prof is None


@pytest.mark.parametrize("w", [8, 7, 5])
def test_read_bmp_matches_jax(tmp_path, w):
    img = _image(6, w, w)
    path = str(tmp_path / "a.bmp")
    jio.write_bmp(path, img)
    np.testing.assert_array_equal(io.read_bmp(path), jio.read_bmp(path))
    np.testing.assert_array_equal(io.read_bmp(path), img)


def test_default_filename_matches_jax():
    kw = dict(width=320, height=200, spp=64, max_depth=7)
    assert io.default_filename(RenderConfig(**kw)) == jio.default_filename(JaxRenderConfig(**kw))
    assert io.default_filename(RenderConfig(**kw), "x", "png") == "x64s7b_320x200.png"


def _png_pixels(data):
    """Decode an 8-bit RGB PNG with filter 0 rows (what both encoders write)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_native_and_python_encoders_agree(tmp_path, monkeypatch):
    assert native.available(), "g++ and zlib build the native encoder here"
    img = _image(9, 13, 1)  # odd width: padded BMP rows
    nat_bmp, nat_png = str(tmp_path / "n.bmp"), str(tmp_path / "n.png")
    io.write_bmp(nat_bmp, img)
    native.write_png(nat_png, img)
    assert io.encoder(nat_bmp) == "native" and io.encoder(nat_png) == "python"
    monkeypatch.setattr(native, "available", lambda: False)
    py_bmp, py_png = str(tmp_path / "p.bmp"), str(tmp_path / "p.png")
    io.write_bmp(py_bmp, img)
    io.write_png(py_png, img)
    assert io.encoder(py_bmp) == "python"
    with open(nat_bmp, "rb") as a, open(py_bmp, "rb") as b:
        assert a.read() == b.read()
    with open(nat_png, "rb") as a, open(py_png, "rb") as b:
        nat, py = a.read(), b.read()
    np.testing.assert_array_equal(_png_pixels(nat), img)
    np.testing.assert_array_equal(_png_pixels(py), img)


def test_native_resolve_matches_the_python_resolve():
    assert native.available()
    accum = np.random.default_rng(3).uniform(0, 9, (5, 6, 3)).astype(np.float32)
    got = native.resolve_gamma_u8(accum, 8, 2.0)
    want = io.to_u8(np.clip(accum / 8.0, 0.0, 1.0) ** 0.5)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
