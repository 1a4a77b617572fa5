"""The ``use_pallas_hits`` gradient route: the closest-hit kernels' plain
versions (``ops/closest_hit.py``) against the JAX package's
``closest_hit_pallas`` / ``closest_hit_attrs_pallas`` in Pallas interpret
mode, the table gathers (``ops/table_gather.py``) against plain autograd
and ``index_add_``, and ``pixel_loss`` through the hits route against the
port's eager route and the JAX package's hits route.

Bounds, and why:

* closest hit: the winner index equal on live rays, its attributes and
  material bit-equal where the index is equal (the kernels copy the table's
  values).  t of ``closest_hit`` equals the IEEE float32 evaluation of the
  JAX kernel's formulation (numpy, every product rounded) to rtol 1e-6 on
  every live hit, plus two roundings of the square root where it cancels
  (PyTorch's CPU sqrt is not correctly rounded: 1 ulp off at times, which a
  ground-sphere root of ~500 shows as ~6e-5 in a t of ~0.3).  Against the
  JAX kernel in interpret mode t differs by more than 1e-6 relative on 14%
  of the hits: XLA's CPU backend contracts the multiply-adds into FMAs, and
  on the cover scene's small spheres the discriminant cancels ~13 bits at
  the camera's distance.  That share is bounded (under 25%) and every such
  t within rtol 1e-3.  Dead rays miss in the port; the JAX kernels' output
  for them depends on their 1024-ray block and is not compared;
* gathers and buckets: ``tests/test_table_gather.py``'s bounds (rtol and
  atol 1e-5 against plain autograd; the bucket against a float64
  ``index_add_`` to 1e-5);
* the hits route against the port's eager route, which picks the winner in
  another formulation and rebuilds t otherwise: ``tests/test_inverse.py:72-86``
  (loss rtol 1e-6, gradients rtol 1e-4, atol 1e-6) and
  ``tests/test_round3_fixes.py:39-58`` (loss rtol 1e-5, gradients rtol
  1e-3, atol 1e-5), the JAX package's bounds for its own hits route against
  its jnp path;
* against the JAX package's hits route on the same scene and key:
  ``tests/test_torch_grad_route.py``'s bound for the port against JAX (loss
  rtol 1e-6, every leaf's gradient rtol 2e-3, atol 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from kernel_cases import AXIS_SPHERES, grazing_rays

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import inverse as jinv
from simplepathtracer_tpu.ops.pallas_intersect import closest_hit_attrs_pallas, closest_hit_pallas

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import inverse
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy
from simplepathtracer_tpu_torch.ops import closest_hit as ch
from simplepathtracer_tpu_torch.ops import grad as fused
from simplepathtracer_tpu_torch.ops import grad_regen
from simplepathtracer_tpu_torch.ops import intersect
from simplepathtracer_tpu_torch.ops.table_gather import (
    attach_attr_columns,
    bucket_rows,
    gather_rows,
    pack_tables,
)
from simplepathtracer_tpu_torch.ops.grad_regen import scene_inputs

CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)


def _jax_tables(scene):
    return (
        scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2], scene.radii,
        scene.radii * scene.radii, scene.albedo[:, 0], scene.albedo[:, 1],
        scene.albedo[:, 2], scene.material.astype(jnp.int32), scene.fuzz, scene.ior,
    )


@pytest.fixture(scope="module")
def cover_rays():
    """The cover preset and 4,096 rays: from the camera, and from random
    points of the scene's box, a fifth of them dead."""
    scene, cam, _ = spt.PRESETS["cover"].build(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    n = 4096
    o = np.tile(np.asarray(cam.origin, np.float32), (n, 1))
    o[n // 2:] = rng.uniform((-8, 0.1, -8), (8, 2, 8), (n // 2, 3))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 1] = -np.abs(d[: n // 2, 1]) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=n) < 0.8
    return scene, o.astype(np.float32), d.astype(np.float32), alive


def _ieee_t(o, d, c, r2):
    """The JAX kernel's t in float32 with every operation rounded (numpy),
    and the square root it took."""
    f = np.float32
    oc = (c - o).astype(f)
    tc = (oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1]).astype(f) + (oc[:, 2] * d[:, 2]).astype(f)
    oc2 = (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]).astype(f) + (oc[:, 2] * oc[:, 2]).astype(f)
    disc = (r2 - (oc2 - (tc * tc).astype(f))).astype(f)
    sq = np.sqrt(np.maximum(disc, f(0)))
    t_near = (tc - sq).astype(f)
    return np.where(t_near > f(1e-3), t_near, (tc + sq).astype(f)), sq


def test_closest_hit_matches_jax_kernel(cover_rays):
    scene, o, d, alive = cover_rays
    j_idx, j_t = closest_hit_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
                                    scene.centers, scene.radii, interpret=True)
    j_idx, j_t = np.asarray(j_idx), np.asarray(j_t)
    ts = convert_scene(scene, "cpu")
    t_idx, t_t = ch.closest_hit_reference(torch.tensor(o), torch.tensor(d), torch.tensor(alive),
                                          ts.centers, ts.radii)
    t_idx, t_t = t_idx.numpy(), t_t.numpy()
    assert t_idx.dtype == np.int32 and t_t.dtype == np.float32
    np.testing.assert_array_equal(t_idx[alive], j_idx[alive])
    np.testing.assert_array_equal(t_idx[~alive], -1)
    np.testing.assert_array_equal(t_t[t_idx < 0], np.float32(3.0e7))
    hits = t_idx >= 0
    assert 0.3 < hits[alive].mean() < 0.95
    c = np.asarray(scene.centers, np.float32)[t_idx[hits]]
    r = np.asarray(scene.radii, np.float32)[t_idx[hits]]
    t_ieee, sq = _ieee_t(o[hits], d[hits], c, (r * r).astype(np.float32))
    # Up to one rounding of the square root: PyTorch's CPU sqrt is not
    # correctly rounded (the kernel's sqrtf and numpy's are).
    assert np.all(np.abs(t_t[hits] - t_ieee) <= 1e-6 * np.abs(t_ieee) + 2 * np.spacing(sq))
    rel = np.abs(t_t[hits] - j_t[hits]) / np.abs(j_t[hits])
    assert (rel > 1e-6).mean() < 0.25, (rel > 1e-6).mean()
    assert rel.max() < 1e-3, rel.max()


@pytest.mark.parametrize("alive_mask", ["all", "some", "none"])
@pytest.mark.parametrize("spheres", ["axis", "cover"])
def test_closest_hit_grazing_rays_match_jax_kernel(spheres, alive_mask):
    """``closest_hit_reference``, which the kernel matches bit for bit on the
    card, on ``kernel_cases.grazing_rays``: tangent rays, rays an ulp off,
    rays from inside, near roots at t_min.  t equals the IEEE float32 evaluation of
    the JAX kernel's formulation (as in test_closest_hit_matches_jax_kernel)
    on every live hit.  Against the JAX kernel in interpret mode: on the
    axis spheres (exact arithmetic) the index is equal on every live ray and
    t within rtol 1e-3 (XLA's FMAs round disc otherwise where it cancels);
    on the cover scene a tangent ray's disc is a few roundings from 0, so
    XLA's FMAs flip a few knife-edge winners: the index is equal on all but
    0.5% of the live rays, and t within rtol 1e-3 where it is.  Dead rays
    miss."""
    if spheres == "axis":
        centers, radii = (torch.tensor(a) for a in AXIS_SPHERES)
    else:
        ts = convert_scene(spt.PRESETS["cover"].build(jax.random.PRNGKey(0))[0], "cpu")
        centers, radii = ts.centers, ts.radii
    o, d = grazing_rays(centers, radii)
    n = o.shape[0]
    alive = {"all": torch.ones(n, dtype=torch.bool), "some": torch.arange(n) % 3 != 0,
             "none": torch.zeros(n, dtype=torch.bool)}[alive_mask]
    t_idx, t_t = (x.numpy() for x in ch.closest_hit_reference(o, d, alive, centers, radii))
    a = alive.numpy()
    np.testing.assert_array_equal(t_idx[~a], -1)
    np.testing.assert_array_equal(t_t[t_idx < 0], np.float32(3.0e7))
    hits = t_idx >= 0
    c, r = centers.numpy()[t_idx[hits]], radii.numpy()[t_idx[hits]]
    t_ieee, sq = _ieee_t(o.numpy()[hits], d.numpy()[hits], c, (r * r).astype(np.float32))
    assert np.all(np.abs(t_t[hits] - t_ieee) <= 1e-6 * np.abs(t_ieee) + 2 * np.spacing(sq))
    if not a.any():
        return
    j_idx, j_t = (np.asarray(x)[a] for x in closest_hit_pallas(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(a),
        jnp.asarray(centers.numpy()), jnp.asarray(radii.numpy()), interpret=True))
    t_idx, t_t = t_idx[a], t_t[a]
    same = t_idx == j_idx
    assert (~same).mean() <= (0.0 if spheres == "axis" else 0.005), (~same).sum()
    assert hits.any() and np.all(np.abs(t_t[same] - j_t[same]) <= 1e-3 * np.abs(j_t[same]))


def test_closest_hit_attrs_matches_jax_kernel(cover_rays):
    scene, o, d, alive = cover_rays
    j_idx, j_attr, j_mat = closest_hit_attrs_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive), _jax_tables(scene), interpret=True)
    j_idx, j_mat = np.asarray(j_idx), np.asarray(j_mat)
    j_attr = np.stack([np.asarray(a) for a in j_attr])
    ts = convert_scene(scene, "cpu")
    t_idx, t_attr, t_mat = ch.closest_hit_attrs_reference(
        torch.tensor(o), torch.tensor(d), torch.tensor(alive), scene_inputs(ts)[:11])
    t_idx, t_mat = t_idx.numpy(), t_mat.numpy()
    t_attr = torch.stack(t_attr).numpy()
    assert t_idx.dtype == np.int32 and t_mat.dtype == np.int32 and t_attr.shape == (9, o.shape[0])
    np.testing.assert_array_equal(t_idx[alive], j_idx[alive])
    same = alive & (t_idx == j_idx)
    np.testing.assert_array_equal(t_attr[:, same], j_attr[:, same])
    np.testing.assert_array_equal(t_mat[same], j_mat[same])
    miss = t_idx < 0
    assert miss[~alive].all() and miss[alive].any()
    np.testing.assert_array_equal(t_attr[:, miss], np.asarray(ch.MISS_ATTRS, np.float32)[:, None]
                                  * np.ones((1, miss.sum()), np.float32))
    np.testing.assert_array_equal(t_mat[miss], 0)


def test_hits_route_builds_the_sphere_table_once_per_trace(cover_rays, monkeypatch):
    """``closest_hit_attrs`` on a prebuilt table gives its own answer, and
    the hits bounce hands it the table its trace built once: one build for
    every ``max_depth`` calls."""
    scene, o, d, alive = cover_rays
    tables = scene_inputs(convert_scene(scene, "cpu"))[:11]
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(alive), tables)
    own = ch.closest_hit_attrs(*args)
    given = ch.closest_hit_attrs(*args, tab=ch.sphere_table(tables))
    assert torch.equal(own[0], given[0]) and torch.equal(own[2], given[2])
    assert all(torch.equal(a, b) for a, b in zip(own[1], given[1]))
    built, sphere_table = [], ch.sphere_table
    monkeypatch.setattr(ch, "sphere_table", lambda t: built.append(1) or sphere_table(t))
    scene, cam, cfg, target = _tiny()
    calls = ch.closest_hit_attrs_reference.calls
    _port_loss_grads(scene, cam, cfg, tpt.make_key(0), target)
    assert built and ch.closest_hit_attrs_reference.calls - calls == len(built) * cfg.max_depth


def test_intersect_scene_pallas_rebuilds_a_differentiable_hit(cover_rays):
    """intersect_scene_pallas: the kernel's winner (kernel 11's formulation)
    and the hit rebuilt by _hit_from_index, differentiable in the scene."""
    scene, o, d, alive = cover_rays
    ts = convert_scene(scene, "cpu")
    centers = ts.centers.clone().requires_grad_(True)
    hit = intersect.intersect_scene_pallas(torch.tensor(o), torch.tensor(d), torch.tensor(alive),
                                           ts.replace(centers=centers))
    idx, t = ch.closest_hit_reference(torch.tensor(o), torch.tensor(d), torch.tensor(alive),
                                      ts.centers, ts.radii)
    assert torch.equal(hit.hit, idx >= 0)
    assert torch.equal(hit.index, torch.clamp(idx, min=0).to(torch.int64))
    np.testing.assert_allclose(hit.t[hit.hit].detach().numpy(), t[idx >= 0].numpy(), rtol=1e-5)
    (g,) = torch.autograd.grad(hit.t[hit.hit].sum(), [centers])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_gather_rows_matches_plain_gather_and_its_gradient():
    gen = torch.Generator().manual_seed(0)
    s, k, n = 37, 9, 1000
    table = torch.randn((s, k), generator=gen).requires_grad_(True)
    idx = torch.randint(0, s, (n,), generator=gen, dtype=torch.int32)
    ct = torch.randn((n, k), generator=gen)
    out = gather_rows(table, idx)
    assert torch.equal(out, table[idx.long()])
    (g,) = torch.autograd.grad(out, [table], ct)
    (g_plain,) = torch.autograd.grad(table[idx.long()], [table], ct)
    np.testing.assert_allclose(g.numpy(), g_plain.numpy(), rtol=1e-5, atol=1e-5)


def test_bucket_rows_matches_float64_index_add():
    gen = torch.Generator().manual_seed(5)
    s, k, n = 37, 9, 1311
    idx = torch.randint(-1, s, (n,), generator=gen, dtype=torch.int32)
    ct = torch.randn((n, k), generator=gen)
    got = bucket_rows(ct, idx, s)
    keep = idx >= 0
    ref = torch.zeros((s, k), dtype=torch.float64).index_add_(
        0, idx[keep].long(), ct[keep].double())
    assert got.shape == (s, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_pack_tables_gradient_splits_to_leaves():
    scene = tpt.three_sphere_scene(device="cpu")
    idx = torch.tensor([0, 2, 1, 3, 0], dtype=torch.int32)
    centers = scene.centers.clone().requires_grad_(True)
    radii = scene.radii.clone().requires_grad_(True)
    sc = scene.replace(centers=centers, radii=radii)
    g1 = torch.autograd.grad(torch.sum(gather_rows(pack_tables(sc), idx) ** 2), [centers, radii])
    i = idx.long()
    plain = (torch.sum(centers[i] ** 2) + torch.sum(radii[i] ** 2)
             + torch.sum(scene.albedo[i] ** 2) + torch.sum(scene.fuzz[i] ** 2)
             + torch.sum(scene.ior[i] ** 2))
    g2 = torch.autograd.grad(plain, [centers, radii])
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_attach_attr_columns_buckets_like_a_gather():
    """The columns pass through; their cotangents reach the table as the
    gather's transpose would, and rows with idx -1 reach nothing."""
    gen = torch.Generator().manual_seed(1)
    s, n = 11, 300
    table = torch.randn((s, 9), generator=gen).requires_grad_(True)
    idx = torch.randint(-1, s, (n,), generator=gen, dtype=torch.int32)
    cols = tuple(torch.where(idx >= 0, table.detach()[idx.clamp(min=0).long(), j], 0.0)
                 for j in range(9))
    out = attach_attr_columns(table, idx, *cols)
    assert all(torch.equal(a, b) for a, b in zip(out, cols))
    w = torch.randn((9, n), generator=gen)
    (g,) = torch.autograd.grad(sum((o * w[j]).sum() for j, o in enumerate(out)), [table])
    keep = idx >= 0
    ref = torch.zeros((s, 9), dtype=torch.float64).index_add_(
        0, idx[keep].long(), w[:, keep].T.double())
    np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# pixel_loss through the hits route


def _port_loss_grads(scene, cam, cfg, key, target):
    params, static = tpt.split_params(scene)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = tpt.pixel_loss(params, static, target, cam, cfg, key, device="cpu")
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), params_to_numpy(dict(zip(params, grads)))


def _hits_setup(case):
    """(port scene, camera, config, key, target, loss rtol, grad rtol, grad
    atol) of the two JAX hits-route tests the port's hits route mirrors."""
    scene = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    cam = tpt.make_camera(**CAM, device="cpu")
    if case == "albedo_perturbed":
        cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=4)
        key = tpt.make_key(0)
        target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 999))
        scene = scene.replace(albedo=torch.clamp(scene.albedo + 0.2, 0, 1))
        return scene, cam, cfg, key, target, 1e-6, 1e-4, 1e-6
    cfg = tpt.RenderConfig(width=16, height=8, spp=2, max_depth=4)
    return scene, cam, cfg, tpt.make_key(2), torch.full((8, 16, 3), 0.25), 1e-5, 1e-3, 1e-5


@pytest.mark.parametrize("case", ["albedo_perturbed", "masked_idx"])
def test_hits_route_matches_eager_route(case):
    scene, cam, cfg, key, target, l_rtol, g_rtol, g_atol = _hits_setup(case)
    calls = ch.closest_hit_attrs_reference.calls
    l_h, g_h = _port_loss_grads(scene, cam, cfg.replace(use_pallas_hits=True), key, target)
    assert ch.closest_hit_attrs_reference.calls == calls + cfg.max_depth
    l_e, g_e = _port_loss_grads(scene, cam, cfg, key, target)
    assert ch.closest_hit_attrs_reference.calls == calls + cfg.max_depth
    np.testing.assert_allclose(l_h, l_e, rtol=l_rtol)
    assert set(g_h) == set(g_e)
    for k in g_e:
        np.testing.assert_allclose(g_h[k], g_e[k], rtol=g_rtol, atol=g_atol, err_msg=k)
    assert np.abs(g_h["albedo"]).max() > 0


@pytest.mark.parametrize("rr", [0, 2], ids=["rr-off", "rr-2"])
def test_hits_route_matches_jax_hits_route(rr):
    jscene = spt.three_sphere_scene(hollow_glass=False)
    jcam = spt.make_camera(**CAM)
    cfg = dict(width=16, height=8, spp=4, max_depth=4, rr_start_depth=rr)
    jcfg = spt.RenderConfig(**cfg, use_pallas_hits=True, pallas_interpret=True)
    target = jnp.full((8, 16, 3), 0.25, jnp.float32)
    params, static = jinv.split_params(jscene)
    j_loss, j_grads = jax.value_and_grad(jinv.pixel_loss)(
        params, static, target, jcam, jcfg, jax.random.PRNGKey(2))
    t_loss, t_grads = _port_loss_grads(
        convert_scene(jscene, "cpu"), convert_camera(jcam, "cpu"),
        tpt.RenderConfig(**cfg, use_pallas_hits=True), tpt.make_key(2),
        torch.full((8, 16, 3), 0.25))
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-6)
    assert set(t_grads) == set(j_grads)
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], np.asarray(g), rtol=2e-3, atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Routes


def _tiny():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(**CAM, device="cpu")
    cfg = tpt.RenderConfig(width=8, height=4, spp=2, max_depth=3, use_pallas_hits=True)
    return scene, cam, cfg, torch.full((4, 8, 3), 0.25)


@pytest.mark.parametrize("which", ["plane", "soft"])
def test_hits_config_on_plane_or_soft_scene_takes_the_eager_bounce(which):
    """The closest-hit kernel is sphere-only and hard: a plane scene or soft
    silhouettes clear use_pallas_hits in trace_rays, as in the JAX package,
    and the loss equals the eager route's."""
    scene, cam, cfg, target = _tiny()
    if which == "plane":
        scene = tpt.with_ground_plane(scene)
    else:
        cfg = cfg.replace(silhouette_softness=0.05)
    calls = ch.closest_hit_attrs_reference.calls
    l_h, _ = _port_loss_grads(scene, cam, cfg, tpt.make_key(0), target)
    assert ch.closest_hit_attrs_reference.calls == calls
    l_e, _ = _port_loss_grads(scene, cam, cfg.replace(use_pallas_hits=False), tpt.make_key(0),
                              target)
    assert l_h == l_e


@pytest.mark.parametrize(
    "flags,route",
    [(dict(), "fused"), (dict(use_pallas_hits=True), "hits"),
     (dict(use_pallas_grad=True, grad_regen=True), "regen")],
    ids=["none", "hits", "regen"],
)
def test_fit_config_routes_as_the_jax_fit(flags, route):
    """fit's config on CUDA (the JAX fit's rule on the TPU,
    inverse.py:427-431): a config naming neither kernel route gets the
    fused kernels, a hits or regen config keeps its route; on the CPU none
    changes.  Each is then run on CPU tensors, where the route's plain
    versions show which route it is."""
    scene, cam, cfg, target = _tiny()
    cfg = cfg.replace(**{"use_pallas_hits": False, **flags})
    assert inverse.fit_config(cfg, "cpu") == tpt.grad_safe_config(cfg, "cpu")
    gcfg = inverse.fit_config(cfg, "cuda")
    assert not gcfg.use_pallas
    counters = (fused.grad_fwd_reference, ch.closest_hit_attrs_reference,
                grad_regen.regen_fwd_reference)
    before = [c.calls for c in counters]
    _port_loss_grads(scene, cam, gcfg, tpt.make_key(0), target)
    ran = [c.calls - b for c, b in zip(counters, before)]
    want = {"fused": [cfg.max_depth, 0, 0], "hits": [0, cfg.max_depth, 0],
            "regen": [0, 0, 1]}[route]
    assert ran == want


def test_closest_hit_wrappers_raise_off_cpu_and_cuda():
    scene, *_ = _tiny()
    o = torch.zeros((4, 3), device="meta")
    alive = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ch.closest_hit(o, o, alive, scene.centers.to("meta"), scene.radii.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ch.closest_hit_attrs(o, o, alive, [t.to("meta") for t in scene_inputs(scene)[:11]])
