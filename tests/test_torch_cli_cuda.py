"""The command line and fit snapshots on the card: a render resumed from its
snapshot equals the uninterrupted one bit for bit (the persistent kernel
has no atomics), and a fit snapshot's round trip is bit-exact, with the
resumed losses within the tolerance ``fit``'s docstring states.  They need
an NVIDIA GPU and skip without one; this file imports no JAX:

    python -m pytest tests/test_torch_cli_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import checkpoint, inverse
from simplepathtracer_tpu_torch.cli import main


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cli_render_resume_bit_identical_on_card(tmp_path):
    _need_card()
    common = ["--preset", "cover", "--width", "64", "--height", "32", "-q"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert main(["render", *common, "--spp", "8", "--snapshot", a, "--snapshot-every", "4",
                 "-o", str(tmp_path / "a.bmp")]) == 0
    assert main(["render", *common, "--spp", "4", "--snapshot", b, "--snapshot-every", "4",
                 "-o", str(tmp_path / "half.bmp")]) == 0
    assert main(["render", "--resume", b, "--spp", "8", "--snapshot", b, "-q",
                 "-o", str(tmp_path / "b.bmp")]) == 0
    sa, sb = checkpoint.load(a)[0], checkpoint.load(b)[0]
    assert sa.accum.is_cuda and sa.sample_count == sb.sample_count == 8
    assert torch.equal(sa.accum, sb.accum)
    with open(tmp_path / "a.bmp", "rb") as fa, open(tmp_path / "b.bmp", "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.cuda
def test_fit_snapshot_round_trip_on_card(tmp_path):
    _need_card()
    scene, cam, cfg = tpt.PRESETS["three_sphere"].build(0)
    cfg = cfg.replace(width=64, height=32, spp=8, max_depth=5)
    target = tpt.render_linear(scene, cam, cfg, tpt.make_key(9))
    start = scene.replace(albedo=torch.clamp(scene.albedo * 0.6, 0.05, 0.95))
    kw = dict(lr=2e-2, softness=0.0, leaves=("albedo", "sky_lo", "sky_hi"))
    key = tpt.make_key(1)
    _, ref = tpt.fit(start, target, cam, cfg, key, steps=4, **kw)
    snap = str(tmp_path / "fit.npz")
    fitted, head = tpt.fit(start, target, cam, cfg, key, steps=2, snapshot_path=snap,
                           snapshot_every=2, **kw)
    params, opt = inverse.init(start, kw["lr"], kw["leaves"])
    assert inverse._load_fit_state(snap, params, opt) == (2, head)
    assert all(torch.equal(params[k], getattr(fitted, k)) for k in kw["leaves"])
    again = str(tmp_path / "again.npz")
    inverse._save_fit_state(again, params, opt, 2, head)
    with np.load(snap) as z1, np.load(again) as z2:
        assert z1.files == z2.files
        for k in z1.files:
            assert z1[k].dtype == z2[k].dtype and np.array_equal(z1[k], z2[k]), k
    _, resumed = tpt.fit(start, target, cam, cfg, key, steps=4, snapshot_path=snap,
                         snapshot_every=2, **kw)
    assert resumed[:2] == head
    np.testing.assert_allclose(resumed, ref, rtol=1e-4)
