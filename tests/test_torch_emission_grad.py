"""Gradients of scenes whose spheres emit light (``Scene.emission``, the
``emission`` leaf of ``inverse.DIFF_LEAVES``).

On the CPU the regeneration route runs its kernels' plain versions
(``ops/grad_regen.py``, the emission term in the kernels' formulation) and
the plain route runs the eager bounce under autograd.  Both are held
against the benchmark's frozen reference of lit gradients
(``port_bench/pb_reference/grad_lit.py``, which imports nothing of the
port) on smallpt's Cornell box and on cover scenes with seeded random
emitters, hard and soft; the emission leaf against a finite difference;
an absent or all-zero emission table against the unlit reference; and the
routes that add no emission still refuse an emissive scene.  The ``cuda``
tests hold the emissive builds of the regeneration kernels bit for bit
against their plain versions on 2,048 lanes, and the emission's bucket
within its float64 bound:

    python -m pytest --noconftest tests/test_torch_emission_grad.py -m cuda
"""

import sys
from pathlib import Path

import pytest
import torch
from kernel_cases import float64_bound
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import inverse, routes, tracing
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pb_reference import grad as ref_unlit, grad_lit  # noqa: E402

REGEN = dict(use_pallas=False, use_pallas_grad=True, grad_regen=True)
PLAIN = dict(use_pallas=False)
SOFT = 0.02
CAMERA = ("origin", "lookat", "vup", "vfov_deg", "aperture", "focus_dist")


def _smallpt(device="cpu"):
    """smallpt's box at 16 x 12 px, 4 spp, depth 10 (roulette from 5)."""
    scene, cam, cfg = tpt.PRESETS["smallpt"].build(0, device=device)
    return scene, cam, cfg.replace(width=16, height=12, spp=4, max_depth=10)


def _cover_lit(seed, device="cpu"):
    """A cover scene (the r = 1000 ground, a grid of small spheres) with
    emission on a seeded random fifth of its spheres, at 24 x 12 px, 4 spp,
    depth 5."""
    scene = tpt.compact_scene(tpt.cover_scene(seed, device=device))
    gen = torch.Generator().manual_seed(seed)
    s = scene.num_spheres
    on = torch.rand(s, generator=gen) < 0.2
    e = torch.rand((s, 3), generator=gen) * 4.0 * on[:, None]
    cam = tpt.PRESETS["cover"].camera_fn(device)
    cfg = tpt.RenderConfig(width=24, height=12, spp=4, max_depth=5)
    return scene.replace(emission=e.to(device)), cam, cfg


CASES = {"smallpt": lambda: _smallpt(), "cover-lit-3": lambda: _cover_lit(3),
         "cover-lit-4": lambda: _cover_lit(4)}


def _static(scene, cam):
    t = {k: getattr(scene, k) for k in grad_lit.SCENE_LEAVES}
    t["material"] = scene.material.to(torch.int64)
    return {"scene": t, "camera": {k: getattr(cam, k) for k in CAMERA}}


def _rcfg(cfg):
    return {k: getattr(cfg, k) for k in ("width", "height", "spp", "max_depth", "t_min",
                                         "t_max", "rr_start_depth")}


def _target(cfg):
    gen = torch.Generator().manual_seed(5)
    return torch.rand((cfg.height, cfg.width, 3), generator=gen) * 0.5


def _port(scene, cam, cfg, flags, soft, key):
    """The port's loss and gradients (decoupled under soft silhouettes)."""
    cfg = cfg.replace(silhouette_softness=soft, **flags)
    params = {k: v.clone().requires_grad_(True) for k, v in inverse.split_params(scene)[0].items()}
    loss_fn = inverse.pixel_loss_decoupled if soft else inverse.pixel_loss
    loss = loss_fn(params, scene, _target(cfg), cam, cfg, key, device="cpu")
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in params.items()}


def _reference(scene, cam, cfg, soft, key, module=grad_lit, **kw):
    leaves = {k: getattr(scene, k) for k in module.SCENE_LEAVES}
    args = (leaves, _static(scene, cam), _target(cfg), (int(key[0]), int(key[1])), _rcfg(cfg),
            soft)
    if module is grad_lit:
        return module.loss_and_grad(*args, decoupled=soft > 0.0, **kw)[:2]
    return module.loss_and_grad(*args, camera=False, decoupled=soft > 0.0, **kw)[:2]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("soft", [0.0, SOFT], ids=["hard", "soft"])
@pytest.mark.parametrize("case", list(CASES))
def test_regen_route_is_the_lit_reference(case, soft):
    """The regeneration route's plain versions against ``grad_lit``: the
    same formulation, so the loss agrees to 1e-6 (the sums' orders differ:
    per lane in iteration order against per path) and each leaf's gradient
    norm to 1e-4 (the bucket's index_add_ against the reference's gathers'
    copies; measured within 1e-5)."""
    scene, cam, cfg = CASES[case]()
    key = tpt.make_key(11)
    before = tracing.counts()
    loss, grads = _port(scene, cam, cfg, REGEN, soft, key)
    ran = tracing.counts() - before
    assert ran["plain.regen_bwd_reference"] >= 1 and ran["plain.regen_fwd_reference"] >= 1
    want, wgrads = _reference(scene, cam, cfg, soft, key)
    assert _rel(loss, want) < 1e-6
    assert set(grads) == set(wgrads) and "emission" in grads
    assert wgrads["emission"].norm() > 0
    for k, g in wgrads.items():
        if g.norm() > 1e-6 * wgrads["emission"].norm():
            assert _rel(grads[k].norm(), g.norm()) < 1e-4, k


@pytest.mark.parametrize("soft", [0.0, SOFT], ids=["hard", "soft"])
@pytest.mark.parametrize("case", ["cover-lit-3", "cover-lit-4"])
def test_plain_route_is_the_lit_reference(case, soft):
    """The plain route (autograd through the eager bounce, the JAX jnp
    path's formulation: the matmul-expanded sphere test) against
    ``grad_lit``.  The formulations round the hit distance apart, which
    flips a few paths at knife edges: the loss within 1e-2 (measured up to
    5.6e-3), and the gradients of the leaves a flipped path moves by its
    value alone (emission, albedo, sky) within 3e-2 (measured up to 1.2e-2).
    The geometry leaves are not compared: their gradient is dominated by
    grazing hits, where the two formulations' derivatives of the hit
    distance differ most (the regeneration route is held to them above)."""
    scene, cam, cfg = CASES[case]()
    key = tpt.make_key(11)
    before = tracing.counts()
    loss, grads = _port(scene, cam, cfg, PLAIN, soft, key)
    assert not any(k.startswith("plain.regen") for k in tracing.counts() - before)
    want, wgrads = _reference(scene, cam, cfg, soft, key)
    assert _rel(loss, want) < 1e-2
    for k in ("emission", "albedo", "sky_lo", "sky_hi"):
        assert _rel(grads[k].norm(), wgrads[k].norm()) < 3e-2, k


@pytest.mark.parametrize("flags", [REGEN, PLAIN], ids=["regen", "plain"])
def test_emission_gradient_is_its_finite_difference(flags):
    """For a fixed key the image is linear in the emission (it changes no
    path) and the loss quadratic, so a central difference along a random
    direction of the table is exact up to rounding: within 1e-3."""
    scene, cam, cfg = _smallpt()
    cfg = cfg.replace(**flags)
    key = tpt.make_key(12)
    gen = torch.Generator().manual_seed(1)
    v = torch.randn(scene.emission.shape, generator=gen)
    _, grads = _port(scene, cam, cfg, {}, 0.0, key)
    eps = 0.25
    with torch.no_grad():
        lo, hi = (inverse.pixel_loss({"emission": scene.emission + s * eps * v}, scene,
                                     _target(cfg), cam, cfg, key, device="cpu")
                  for s in (-1.0, 1.0))
    fd = (float(hi) - float(lo)) / (2 * eps)
    assert _rel(float((grads["emission"] * v).sum()), fd) < 1e-3


@pytest.mark.parametrize("soft", [0.0, SOFT], ids=["hard", "soft"])
def test_absent_or_dark_emission_is_the_unlit_gradient(soft):
    """With an all-zero table the lit reference is the unlit one
    (``pb_reference/grad.py``) bit for bit, and the port's regeneration
    route gives every shared leaf the gradient it gives without the table,
    bit for bit (an emissive build adds tp x 0)."""
    scene, cam, cfg = _cover_lit(3)
    dark = scene.replace(emission=torch.zeros_like(scene.emission))
    key = tpt.make_key(13)
    want, wgrads = _reference(dark, cam, cfg, soft, key)
    unlit, ugrads = _reference(dark, cam, cfg, soft, key, module=ref_unlit)
    assert want == unlit
    for k, g in ugrads.items():
        assert torch.equal(wgrads[k], g), k
    loss_z, g_z = _port(dark, cam, cfg, REGEN, soft, key)
    loss_n, g_n = _port(scene.replace(emission=None), cam, cfg, REGEN, soft, key)
    assert loss_z == loss_n and "emission" in g_z and "emission" not in g_n
    for k, g in g_n.items():
        assert torch.equal(g_z[k], g), k


@pytest.mark.parametrize("flags,soft", [
    (dict(use_pallas=True), 0.0),
    (dict(use_pallas_hits=True), 0.0),
    (dict(use_pallas_hits=True), SOFT),
    (dict(use_pallas_grad=True), 0.0),
    (dict(use_pallas_grad=True, camera_grad=True), SOFT),
    (dict(use_pallas_grad=True, grad_regen=True, camera_grad=True), 0.0),
], ids=["bounce_step", "hits", "hits-soft", "fused_raygen", "fused-camera", "regen-camera"])
def test_routes_without_emission_refuse_it_with_no_fallback(flags, soft):
    """The bounce-step, closest-hit and fused routes (and camera gradients,
    whose CUDA route is the fused one) raise on an emissive scene, even
    where an unlit scene would fall back to the plain route, and so does a
    differentiated all-zero table there; ``fit_camera`` and ``fit_sharded``
    raise too."""
    scene, cam, cfg = _smallpt()
    cfg = cfg.replace(silhouette_softness=soft, **dict(PLAIN, **flags))
    entry = routes.PIXELS if flags.get("use_pallas") else routes.BLOCK
    with pytest.raises(NotImplementedError, match="emission"):
        routes.pick(scene, cfg, entry=entry)
    if not flags.get("use_pallas"):
        dark = scene.replace(emission=torch.zeros_like(scene.emission).requires_grad_(True))
        with pytest.raises(NotImplementedError, match="emission"):
            routes.pick(dark, cfg, entry=entry)
        assert routes.pick(scene.replace(emission=None), cfg, entry=entry).name
    target = _target(cfg)
    with pytest.raises(NotImplementedError, match="emission"):
        tpt.fit_camera(scene, target, cam, cfg, tpt.make_key(2), steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="emission"):
        inverse.fit_sharded(scene, target, cam, cfg, tpt.make_key(2), None, steps=1,
                            device="cpu")


# --------------------------------------------------------------------------
# On the card


def _card_call(case, soft, n_lanes=2048, n_samples=4):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if case == "smallpt":
        scene, cam, cfg = tpt.PRESETS["smallpt"].build(0, device="cuda")
        cfg = cfg.replace(width=64, height=48)
    else:
        scene, cam, cfg = _cover_lit(3, device="cuda")
        scene = tpt.with_ground_plane(scene) if case == "cover-plane" else scene
        cfg = cfg.replace(width=64, height=48, rr_start_depth=2)
    cfg = cfg.replace(silhouette_softness=soft)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    pix = torch.randperm(cfg.num_pixels, generator=torch.Generator().manual_seed(7))[:n_lanes]
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(3), pix.to("cuda"),
        n_samples=n_samples, max_depth=cfg.max_depth, width=cfg.width, height=cfg.height,
        t_min=cfg.t_min, rr_start_depth=cfg.rr_start_depth, softness=soft,
        emission=inputs[13],
    )


@pytest.mark.cuda
@pytest.mark.parametrize("case,soft", [("smallpt", 0.0), ("smallpt", SOFT), ("cover", SOFT),
                                       ("cover-plane", 0.0), ("cover-plane", SOFT)],
                         ids=["smallpt-hard", "smallpt-soft", "cover-soft", "plane-hard",
                              "plane-soft"])
def test_emissive_builds_are_their_plain_versions_on_card(case, soft):
    """The emissive builds on 2,048 lanes: the forward in both modes, the
    re-forward and the backward bit for bit against their plain versions,
    each launch counted as emissive; the winner's 12-column bucket
    (attributes and emission) within the float64 bound."""
    call = _card_call(case, soft)
    v = gr.variant(call)
    before = tracing.counts()
    rad, cnt, (resf, resi) = gr.regen_forward(call, 5, True)
    rad_p, cnt_p, (resf_p, resi_p) = gr.regen_fwd_reference(call, 5, True)
    alive = resf_p[9] > 0
    assert torch.equal(rad, rad_p) and torch.equal(cnt, cnt_p)
    assert torch.equal(resf[9], resf_p[9]) and torch.equal(resi[3], resi_p[3])
    assert torch.equal(resf[:, alive], resf_p[:, alive])
    assert torch.equal(resi[:, alive], resi_p[:, alive])
    rad_i, cnt_i, packed = gr.regen_forward(call, 5, False)
    assert torch.equal(rad_i, rad) and torch.equal(cnt_i, cnt)
    assert torch.equal(packed, gr.regen_fwd_reference(call, 5, False)[2])
    rf, ri = gr.regen_refwd(call, 5, packed)
    assert torch.equal(rf[:, alive], resf[:, alive]) and torch.equal(ri[3], resi[3])
    ct = torch.randn((call.pixel_ids.shape[0], 3), device="cuda")
    ctp, part = gr.regen_backward(call, 5, resf, resi, ct)
    ctp_p, part_p = gr.regen_bwd_reference(call, 5, resf, resi, ct)
    assert ctp.shape[0] == (16 if soft else 12)
    assert torch.equal(ctp, ctp_p) and torch.equal(part, part_p)
    ran = tracing.counts() - before
    for k in ("regen_forward", "regen_refwd", "regen_backward"):
        assert ran[f"launch.{k}.{v}.emit"] == ran[f"launch.{k}.{v}"] >= 1, k
    d = bucket.bucket_cols(ctp[:12], resi[3], call.n_spheres)
    want, tol = float64_bound(ctp[:12], resi[3], call.n_spheres)
    assert bool(((d.double() - want).abs() <= tol).all())
    assert (tracing.counts() - before)["launch.bucket.12"] == 1
    # Emitters were hit, so the emission's columns carry cotangents.
    assert d[:, 9:].abs().sum() > 0


@pytest.mark.cuda
def test_dark_table_keeps_the_unlit_values_on_card():
    """An all-zero table takes the emissive builds and gives the unlit
    builds' radiance and cotangents bit for bit (tp x 0 added)."""
    call = _card_call("smallpt", SOFT)
    dark = call._replace(emit=torch.zeros_like(call.emit))
    unlit = call._replace(emit=None)
    rad_d, _, (rf, ri) = gr.regen_forward(dark, 0, True)
    rad_u, _, (rfu, riu) = gr.regen_forward(unlit, 0, True)
    # Dead entries hold alive, idx and bidx alone (the other planes are not
    # written there): compare those, and every plane on the live entries.
    alive = rfu[9] > 0
    assert torch.equal(rad_d, rad_u) and torch.equal(rf[9], rfu[9])
    assert torch.equal(ri[3], riu[3]) and torch.equal(ri[gr._I_BLK], riu[gr._I_BLK])
    assert torch.equal(rf[:, alive], rfu[:, alive]) and torch.equal(ri[:, alive], riu[:, alive])
    ct = torch.randn((call.pixel_ids.shape[0], 3), device="cuda")
    ctp_d, part_d = gr.regen_backward(dark, 0, rf, ri, ct)
    ctp_u, part_u = gr.regen_backward(unlit, 0, rf, ri, ct)
    assert torch.equal(ctp_d[:9], ctp_u[:9]) and torch.equal(ctp_d[12:], ctp_u[9:])
    assert torch.equal(part_d, part_u)
