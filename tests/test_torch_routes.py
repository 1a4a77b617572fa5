"""The port's route table, pinned: which route each entry point takes for
each combination of the config's kernel flags and the scene's features
(ground plane, soft silhouettes, emission).

Each case runs one entry point on the CPU at 16x8 px, 2 spp in chunks of 1,
depth 3, and reads which route ran from the plain versions' call counters
(``tracing.counts()``): forward, and for the gradient entries the backward
too.  An emissive scene raises where the flags name a route that adds no
emission (every route but the persistent, regeneration and plain ones),
with no fallback.  The same call then goes to ``routes.pick`` as a pure
function, and so does the
cover preset's config on CUDA (a config decision: no card needed), where
``grad_safe_config`` / ``fit_config`` give the route and spp chunk the
cover cells differentiate with.
"""

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import routes, tracing
from simplepathtracer_tpu_torch.routes import fit_config

FLAGS = {
    "pallas": dict(use_pallas=True),
    "plain": {},
    "hits": dict(use_pallas_hits=True),
    "fused": dict(use_pallas_grad=True),
    "regen": dict(use_pallas_grad=True, grad_regen=True),
    "regen_chunked": dict(use_pallas_grad=True, grad_regen=True, grad_regen_stream=False),
    "camera": dict(use_pallas_grad=True, grad_regen=True, camera_grad=True),
}
ENTRIES = ("render", "render_pixels", "pixel_loss", "fit_config")
SOFT = 0.05

# The plain versions each route calls (besides the eager bounce, which
# counts nothing): (forward, backward).  The backward of a route that
# renders chunk by chunk also runs each chunk's forward again (remat).
RAN = {
    "persistent": ({"render_block_persistent_reference"}, set()),
    "bounce_step": ({"bounce_step_reference", "camera_jitter_reference"}, set()),
    "regen_stream": ({"regen_fwd_reference"},
                     {"regen_refwd_reference", "regen_bwd_reference", "bucket_cols_reference"}),
    "regen": ({"regen_fwd_reference"}, {"regen_bwd_reference", "bucket_cols_reference"}),
    "fused_raygen": ({"raygen_reference", "grad_fwd_reference"},
                     {"grad_bwd_reference", "bucket_cols_reference"}),
    "fused": ({"camera_jitter_reference", "grad_fwd_reference"},
              {"grad_bwd_reference", "bucket_cols_reference"}),
    "hits": ({"camera_jitter_reference", "closest_hit_attrs_reference"},
             {"bucket_cols_reference"}),
    "plain": ({"camera_jitter_reference"}, set()),
}


def _want(entry, cfg, plane, soft):
    """Today's dispatch, written out: the route ``cfg`` takes through
    ``render_pixel_block`` (``render_pixels`` for that entry)."""
    if cfg.use_pallas:
        return "bounce_step" if entry == "render_pixels" else "persistent"
    regen = cfg.use_pallas_grad and cfg.grad_regen and not cfg.camera_grad
    if entry != "render_pixels" and regen:
        chunked = 0 < cfg.spp_chunk < cfg.spp
        return "regen_stream" if cfg.grad_regen_stream and chunked else "regen"
    if cfg.use_pallas_grad and not plane:
        return "fused" if cfg.camera_grad else "fused_raygen"
    if cfg.use_pallas_hits and not cfg.use_pallas_grad and not (plane or soft):
        return "hits"
    return "plain"


# The routes that add emission (the streamed regeneration route's own name
# is "regen_stream"; ``_asked`` names both "regen").
LIT = ("persistent", "regen", "plain")


def _asked(entry, cfg):
    """The route the flags name for ``entry``, before any fallback."""
    if cfg.use_pallas:
        return "bounce_step" if entry == "render_pixels" else "persistent"
    if cfg.use_pallas_grad:
        if entry != "render_pixels" and cfg.grad_regen and not cfg.camera_grad:
            return "regen"
        return "fused"
    return "hits" if cfg.use_pallas_hits else "plain"


def _scene(plane, emit):
    scene = tpt.three_sphere_scene(device="cpu")
    if plane:
        scene = tpt.with_ground_plane(scene)
    if emit:
        e = torch.zeros((scene.num_spheres, 3))
        e[1] = 2.0
        scene = scene.replace(emission=e)
    return scene


def _config(flags, soft, **kw):
    return tpt.RenderConfig(**{**kw, **FLAGS[flags]}, silhouette_softness=SOFT if soft else 0.0)


def _counts(before):
    return {k[len("plain."):] for k, v in (tracing.counts() - before).items()
            if k.startswith("plain.") and v}


def _run(entry, scene, cam, cfg):
    """(plain versions run forward, and backward or None)."""
    key = tpt.make_key(1)
    before = tracing.counts()
    if entry == "render":
        tpt.render(scene, cam, cfg, key)
        return _counts(before), None
    if entry == "render_pixels":
        pids = torch.arange(cfg.num_pixels)
        tpt.render_pixels(scene, cam, cfg, key, pids, torch.zeros_like(pids))
        return _counts(before), None
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(scene)[0].items()}
    target = torch.full((cfg.height, cfg.width, 3), 0.25)
    loss = tpt.pixel_loss(params, scene, target, cam, cfg, key, device="cpu")
    fwd = _counts(before)
    before = tracing.counts()
    loss.backward()
    return fwd, _counts(before)


def _pick(entry, scene, cfg, differentiates=False):
    entry = routes.PIXELS if entry == "render_pixels" else routes.BLOCK
    return routes.pick(scene, cfg, entry=entry, differentiates=differentiates)


CASES = [(e, f, p, s, m) for e in ENTRIES for f in FLAGS
         for p in (False, True) for s in (False, True) for m in (False, True)]


def _id(case):
    e, f, p, s, m = case
    return "-".join([e, f, "plane" if p else "spheres", "soft" if s else "hard",
                     "lit" if m else "unlit"])


@pytest.mark.parametrize("entry,flags,plane,soft,emit", CASES, ids=[_id(c) for c in CASES])
def test_route_table(entry, flags, plane, soft, emit):
    scene = _scene(plane, emit)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cfg = _config(flags, soft, width=16, height=8, spp=2, spp_chunk=1, max_depth=3)

    # The cover preset's config on CUDA: the chunk grad_safe_config picks
    # from the route's budget (regeneration 20 spp, fused 52, plain 2);
    # fit_config then names the fused kernels where no kernel route is set.
    cover = _config(flags, soft, **{
        f: getattr(tpt.PRESETS["cover"].config, f) for f in ("width", "height", "spp", "max_depth")})
    if entry in ("pixel_loss", "fit_config"):
        gcover = tpt.grad_safe_config(cover, "cuda")
        regen = gcover.use_pallas_grad and gcover.grad_regen and not gcover.camera_grad
        assert gcover.spp_chunk == (20 if regen else 52 if gcover.use_pallas_grad else 2)
        assert routes.pick(None, gcover).max_chunk == gcover.spp_chunk
        if entry == "fit_config":
            fcover = fit_config(cover, "cuda")
            assert fcover.spp_chunk == gcover.spp_chunk
            assert fcover.use_pallas_grad == (gcover.use_pallas_grad or not gcover.use_pallas_hits)
            gcover = fcover
        cover = gcover
    want_cover = _want(entry, cover, plane, soft)
    if emit and _asked(entry, cover) not in LIT:
        with pytest.raises(NotImplementedError, match="emission"):
            _pick(entry, scene, cover)
    else:
        assert _pick(entry, scene, cover).name == want_cover

    if entry == "fit_config":
        cfg = fit_config(cfg, "cuda")
    run_cfg = cfg if entry in ("render", "render_pixels") else tpt.grad_safe_config(cfg, "cpu")
    want = _want(entry, run_cfg, plane, soft)
    if emit and _asked(entry, run_cfg) not in LIT:
        with pytest.raises(NotImplementedError, match="emission"):
            _pick(entry, scene, run_cfg)
        with pytest.raises(NotImplementedError, match="emission"):
            _run(entry, scene, cam, cfg)
        return
    route = _pick(entry, scene, run_cfg, differentiates=entry in ("pixel_loss", "fit_config"))
    assert route.name == want and route.forward_only == (want in ("persistent", "bounce_step"))
    assert route.camera_detached == (want in ("regen_stream", "regen", "fused_raygen"))
    assert route.keep_words == (want == "regen_stream" and entry != "render")
    fwd, bwd = _run(entry, scene, cam, cfg)
    assert fwd == RAN[want][0]
    if bwd is not None:
        remat = RAN[want][0] if want != "regen_stream" else set()
        assert bwd == RAN[want][1] | remat
