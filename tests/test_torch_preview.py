"""The port's live HTTP preview (mirror of ``tests/test_preview.py``): the
server's page, frame and status, and ``render --http-preview`` on the CPU."""

import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from simplepathtracer_tpu import io as jio
from simplepathtracer_tpu_torch import io
from simplepathtracer_tpu_torch.cli import main
from simplepathtracer_tpu_torch.preview import PreviewServer


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def test_preview_server_serves_frames():
    srv = PreviewServer(port=0, host="127.0.0.1")
    try:
        status, body = _get(srv.port, "/")
        assert status == 200 and b"simplepathtracer_tpu_torch" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/frame.png")  # no frame yet
        assert e.value.code == 404

        img = np.linspace(0, 1, 8 * 6 * 3, dtype=np.float32).reshape(6, 8, 3)
        srv.update(torch.from_numpy(img), status="3/8 spp")
        status, png = _get(srv.port, "/frame.png")
        assert status == 200 and png == io.encode_png(img) == jio.encode_png(img)
        assert _get(srv.port, "/status") == (200, b"3/8 spp")
    finally:
        srv.close()


def test_cli_http_preview_flag(tmp_path, capsys):
    out = str(tmp_path / "preview.png")
    assert main(["render", "--preset", "simple", "--width", "16", "--height", "8",
                 "--spp", "4", "--max-depth", "2", "--no-pallas", "--device", "cpu",
                 "--http-preview", "--snapshot-every", "2", "-o", out]) == 0
    phases = [line.split('"')[3] for line in capsys.readouterr().err.splitlines()
              if line.startswith("{")]
    assert phases == ["preview", "render", "render", "done"]
