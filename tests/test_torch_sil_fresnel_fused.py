"""``SIL_FRESNEL`` on the fused route: the per-bounce fused kernels' plain
versions (``ops/grad.py``) against the JAX package's fused kernels in
Pallas interpret mode, the switch on in both packages, on the same rays
(the ``soft`` case and the bounds of ``test_torch_fused_kernels.py``).
Then the switch off in the port on the same rays: the forward is bit for
bit the same, the ``ior`` and ray cotangents move, the sky's do not.  The
other routes are in ``test_torch_sil_fresnel.py``.
"""

import torch
from torch_threads import one_torch_thread  # noqa: F401

import test_torch_fused_kernels as fk
from test_torch_sil_fresnel import fresnel  # noqa: F401
from simplepathtracer_tpu_torch.ops import intersect


def test_fresnel_fused_route_matches_jax(fresnel, monkeypatch):
    on = fk.build_case("soft")
    fk.check_forward(on)
    fk.check_backward(on)
    monkeypatch.setattr(intersect, "SIL_FRESNEL", False)
    out_off, grads_off = fk.port_grads(on)
    assert torch.equal(out_off, on["out"])
    ior = on["params"].index("ior") + 2
    assert (on["grads"][ior] - grads_off[ior]).abs().max() > 1e-6
    # The rays' cotangents move too (through cos_t); the sky's do not.
    assert not torch.equal(on["grads"][1], grads_off[1])
    for k in ("sky_lo", "sky_hi"):
        i = on["params"].index(k) + 2
        assert torch.equal(on["grads"][i], grads_off[i]), k
