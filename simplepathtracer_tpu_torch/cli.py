"""Command-line entry point of the PyTorch port (counterpart of the JAX
package's ``cli.py``): ``render``, ``invert`` and ``info``, with the JAX
CLI's flags and their meanings, plus ``--device`` (``cuda`` unless named).

Usage:
    python -m simplepathtracer_tpu_torch.cli render --preset cover -o cover.png
    python -m simplepathtracer_tpu_torch.cli render --preset simple --spp 64 \\
        --snapshot-every 16 --snapshot out.npz --preview preview.png
    python -m simplepathtracer_tpu_torch.cli render --resume out.npz -o done.png
    python -m simplepathtracer_tpu_torch.cli invert --preset cover -o trip.png
    python -m simplepathtracer_tpu_torch.cli invert --steps 60 --device cpu
    python -m simplepathtracer_tpu_torch.cli info

Progress goes to standard error as JSON lines (``metrics.Meter``).  Where
the JAX CLI decides by backend, this one decides by the device: on CUDA a
preset fit runs the preset's spp and renders its target and artifacts
through the persistent kernel; on the CPU the fit's spp is clamped to 32
and those renders take the plain route.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import checkpoint, inverse, io, metrics
from .camera import generate_rays
from .ops.intersect import intersect_scene
from .ops.sampling import fold_in, make_key
from .presets import PRESETS
from .preview import PreviewServer
from .render import accumulate, grad_safe_config, init_state, stream_capacity_spp
from .scenes import three_sphere_scene
from .types import RenderConfig, make_camera


def _device(args) -> torch.device:
    """The device a command runs on; CUDA unless ``--device`` names
    another, and without CUDA that raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return dev


def _apply_overrides(config: RenderConfig, args) -> RenderConfig:
    kw = {}
    for field in ("width", "height", "spp", "max_depth", "spp_chunk", "balance_probe_spp"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    if getattr(args, "no_pallas", False):
        kw["use_pallas"] = False
    return config.replace(**kw) if kw else config


def cmd_render(args) -> int:
    dev = _device(args)
    meter = metrics.Meter(enabled=not args.quiet)
    key = make_key(args.seed)

    if args.resume:
        state, scene, config, camera = checkpoint.load(args.resume, device=dev)
        config = _apply_overrides(config, args)
        if camera is None:  # a snapshot written without a camera: the preset's
            camera = PRESETS[args.preset].camera_fn(dev)
        done = state.sample_count
        meter.emit({"phase": "resume", "from": args.resume, "samples_done": done})
    else:
        scene, camera, config = PRESETS[args.preset].build(args.scene_seed, device=dev)
        config = _apply_overrides(config, args)
        state = init_state(config, key, device=dev)
        done = 0

    server = None
    if args.http_preview is not None:
        server = PreviewServer(port=args.http_preview)
        meter.emit({"phase": "preview", "url": f"http://localhost:{server.port}/"})

    total = config.spp
    chunk = args.snapshot_every or (total - done)
    if server is not None and not args.snapshot_every:
        # A live preview needs intermediate frames: about 20 updates.
        chunk = max(1, total // 20)
    try:
        with metrics.profiler_trace(args.trace):
            while done < total:
                n = min(chunk, total - done)
                with meter.phase("render", paths=config.num_pixels * n,
                                 bounces=config.max_depth):
                    state = accumulate(state, scene, camera, config, n)
                done += n
                if args.snapshot:
                    checkpoint.save(args.snapshot, state, scene, config, camera)
                    meter.emit({"phase": "snapshot", "path": args.snapshot, "spp": done})
                if args.preview or server is not None:
                    img = state.image(config.gamma).cpu().numpy()
                    if args.preview:
                        io.save_image(args.preview, img)
                    if server is not None:
                        server.update(img, status=f"{done}/{total} spp")
    finally:
        if server is not None:
            server.close()

    out = args.output or io.default_filename(config)
    io.save_image(out, state.image(config.gamma).cpu().numpy())
    meter.emit({"phase": "done", "output": out, "spp": done, "encoder": io.encoder(out)})
    return 0


def _fit(meter, phase, *fit_args, **fit_kw):
    """``inverse.fit`` with a callback that emits the loss every 5 steps, as
    the JAX CLI does, then one record of the steps it ran and each step's
    seconds (none when it resumed at its last step).  The callback runs
    after the step's loss reached the host, so the card's work is in them;
    the first step's include the fit's set-up."""
    step_s, last = [], [time.perf_counter()]

    def callback(i, loss, params):
        now = time.perf_counter()
        step_s.append(round(now - last[0], 4))
        last[0] = now
        if i % 5 == 0:
            meter.emit({"phase": phase, "step": i, "loss": loss})

    scene, losses = inverse.fit(*fit_args, callback=callback, **fit_kw)
    meter.emit({"phase": f"{phase}_steps", "steps_run": len(step_s), "step_s": step_s})
    return scene, losses


def _invert_preset(args) -> int:
    """Preset-scale inverse rendering: perturb a preset scene's albedos and
    the positions of its most prominent visible Lambertian spheres, recover
    them against a rendered target, and write a before | target | after
    artifact."""
    dev = _device(args)
    meter = metrics.Meter(enabled=not args.quiet)
    truth, camera, config = PRESETS[args.preset].build(args.scene_seed, device=dev)
    config = _apply_overrides(config, args)
    if args.spp is None and dev.type != "cuda":
        # The CPU clamps the preset's spp; on the card the fit runs its own.
        config = config.replace(spp=min(config.spp, 32))
    if config.rr_start_depth == 0:
        # Russian roulette is on for fits: unbiased, and its gradients are
        # tested under it.
        config = config.replace(rr_start_depth=2)
    if args.grad_regen:
        config = config.replace(grad_regen=True)
    # Cost-balanced order is off unless asked for: on the card the kernels
    # fetch lanes from a counter (one bank), so the order only sorts pixels
    # by cost, and a balanced cover hard-fit step measured 1.9-2.0% slower.
    balance = args.balance and not args.no_balance
    key = make_key(args.seed)
    gcfg = grad_safe_config(config, dev)
    # Target and artifact renders are forward only: on the card the preset's
    # config (the persistent kernel), on the CPU the plain route.
    rcfg = config if dev.type == "cuda" else gcfg.replace(grad_regen=False, use_pallas_grad=False)

    with torch.no_grad():
        target = inverse.render_linear(truth, camera, rcfg, fold_in(key, 999))

    # Perturb every visible non-ground albedo (the ground: the largest
    # |radius|) and the positions of the K most prominent visible
    # Lambertian spheres (projected size |r| / distance).
    radii_n = truth.radii.cpu().numpy()
    ground = int(np.argmax(np.abs(radii_n)))
    centers_n = truth.centers.cpu().numpy()
    cam_o = camera.origin.cpu().numpy()
    prominence = np.abs(radii_n) / np.linalg.norm(centers_n - cam_o, axis=1)
    prominence[ground] = 0.0
    # Hollow-glass shell pairs must move together: geometry on Lambertian
    # spheres only.
    prominence[truth.material.cpu().numpy() != 0] = 0.0
    # Only primary-visible spheres are fitted: the gradient of the others is
    # Monte-Carlo noise, which Adam turns into a random walk.  The probe runs
    # at quarter resolution: intersect_scene holds [rays, spheres] planes,
    # and spheres under ~4 px are noise-dominated anyway.
    pw, ph = max(config.width // 4, 1), max(config.height // 4, 1)
    pix = torch.arange(pw * ph, dtype=torch.int32, device=dev)
    with torch.no_grad():
        o_p, d_p = generate_rays(camera, pw, ph, pix,
                                 torch.full((pw * ph, 4), 0.5, device=dev))
        prim = intersect_scene(o_p, d_p, truth, config.t_min, config.t_max)
    vis_idx = np.unique(prim.index.cpu().numpy()[prim.hit.cpu().numpy()])
    visible = np.zeros(len(radii_n), bool)
    visible[vis_idx] = True
    visible[ground] = False
    prominence[~visible] = 0.0
    to_c = centers_n - cam_o
    k_geo = min(6, int((prominence > 0).sum()))
    geo_idx = np.argsort(-prominence)[:k_geo]
    # Sub-radius offsets tangential to each sphere's view ray: soft
    # silhouettes need the perturbed and true silhouettes to overlap, and one
    # view cannot observe depth.
    dirs = np.asarray(
        [[1, 0, 0.5], [-1, 0.3, 0], [0.4, 0, -1], [-0.5, 0.2, 0.8],
         [0.9, 0, -0.3], [-0.2, 0.4, 1]], np.float32)[:k_geo]
    view = to_c[geo_idx] / np.linalg.norm(to_c[geo_idx], axis=1, keepdims=True)
    dirs = dirs - np.sum(dirs * view, axis=1, keepdims=True) * view
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    c_delta = np.zeros_like(centers_n)
    c_delta[geo_idx] = dirs * (0.35 * np.abs(radii_n[geo_idx]))[:, None]

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    delta = dev_t(visible.astype(np.float32)[:, None] * 0.18)
    perturbed = truth.replace(
        albedo=torch.clamp(truth.albedo + delta, 0.03, 0.97),
        centers=truth.centers + dev_t(c_delta),
    )
    mask_a = {"albedo": dev_t(visible.astype(np.float32)[:, None] * np.ones((1, 3)))}
    mask_c = {"centers": dev_t((c_delta != 0).any(axis=1, keepdims=True) * np.ones((1, 3)))}
    n_fit = float(mask_a["albedo"][:, :1].sum()) * 3.0

    def albedo_err(scene):
        # Mean: the recovery metric; max: the random walk of occluded or
        # sub-pixel spheres, which grows with lr * steps.
        d = (scene.albedo - truth.albedo).abs() * mask_a["albedo"]
        return float(d.sum() / n_fit), float(d.max())

    def center_err(scene):
        if k_geo == 0:  # tiny probes can leave no geometry candidates
            return 0.0, 0.0
        d = np.linalg.norm((scene.centers - truth.centers).cpu().numpy()[geo_idx], axis=1)
        return float(d.mean()), float(d.max())

    err0_mean, err0_max = albedo_err(perturbed)
    cerr0_mean, cerr0 = center_err(perturbed)
    with torch.no_grad():
        before = inverse.render_linear(perturbed, camera, rcfg, key)

    def snap_kw(phase):
        if not args.snapshot:
            return {}
        return dict(snapshot_path=f"{args.snapshot}.{phase}.npz",
                    snapshot_every=args.snapshot_every)

    # spp beyond the streamed-idx capacity: the gradient-accumulated
    # estimator, K the smallest divisor of spp whose groups fit.
    cap = stream_capacity_spp(config, truth)
    grad_accum = args.grad_accum
    if not grad_accum and cap and config.spp > cap:
        grad_accum = next(k for k in range(2, config.spp + 1)
                          if config.spp % k == 0 and config.spp // k <= cap)
        meter.emit({"phase": "grad_accum", "groups": grad_accum,
                    "spp_per_group": config.spp // grad_accum})
    # Two-phase coordinate descent: albedo against the hard target, then
    # albedo and geometry with soft silhouettes against a soft target.
    # Albedo converges in < 40 steps, and more albedo-only steps walk its
    # converged but noisy entries.
    softness = 0.02
    s1 = max(min(args.steps // 3, 40), 1)
    fit_kw = dict(balance=balance, grad_accum=grad_accum, device=dev)
    stage1, losses1 = _fit(
        meter, "invert_albedo", perturbed, target, camera, config, key,
        steps=s1, lr=args.lr, leaves=("albedo",), param_mask=mask_a,
        **fit_kw, **snap_kw("albedo"),
    )
    with torch.no_grad():
        target_soft = inverse.render_linear(
            truth, camera, gcfg.replace(silhouette_softness=softness), fold_in(key, 999),
        )
    # With albedo frozen at its phase-1 residual the centers would chase the
    # shading error: phase 2 fits both.
    phase2_leaves = ("albedo", "centers") if k_geo else ("albedo",)
    phase2_mask = {**mask_a, **mask_c} if k_geo else mask_a
    recovered, losses2 = _fit(
        meter, "invert_centers", stage1, target_soft, camera, config,
        fold_in(key, 1), steps=args.steps - s1, lr=min(args.lr, 1e-2),
        leaves=phase2_leaves, softness=softness, param_mask=phase2_mask,
        **fit_kw, **snap_kw("centers"),
    )
    losses = losses1 + losses2
    err1_mean, err1_max = albedo_err(recovered)
    cerr1_mean, cerr1 = center_err(recovered)
    with torch.no_grad():
        after = inverse.render_linear(recovered, camera, rcfg, key)
    meter.emit({
        "phase": "invert_done", "preset": args.preset,
        "spp": config.spp, "size": f"{config.width}x{config.height}",
        "loss_first": losses[0], "loss_last": losses[-1],
        "albedo_err_before": err0_mean, "albedo_err_after": err1_mean,
        "albedo_maxerr_before": err0_max, "albedo_maxerr_after": err1_max,
        "center_spheres": [int(i) for i in geo_idx],
        "center_err_before": cerr0, "center_err_after": cerr1,
        "center_err_mean_before": cerr0_mean,
        "center_err_mean_after": cerr1_mean,
    })
    if args.output:
        trip = torch.cat([before, target, after], dim=0).cpu().numpy()
        io.save_image(args.output, np.clip(trip, 0, 1) ** 0.5)
        meter.emit({"phase": "artifact", "output": args.output,
                    "layout": "rows: before | target | after"})
    return 0


def cmd_invert(args) -> int:
    if args.preset:
        return _invert_preset(args)

    dev = _device(args)
    meter = metrics.Meter(enabled=not args.quiet)
    camera = make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device=dev)
    config = RenderConfig(width=args.width or 96, height=args.height or 48,
                          spp=args.spp or 16, max_depth=args.max_depth or 6)
    if args.grad_regen:
        config = config.replace(use_pallas_grad=True, grad_regen=True)
    key = make_key(args.seed)

    # Ground truth -> targets (hard for the albedo phase, soft for the
    # geometry phase: soft-to-soft); the perturbed scene is recovered with
    # the ground sphere frozen.
    softness = 0.05
    truth = three_sphere_scene(hollow_glass=False, device=dev)
    with torch.no_grad():
        target_hard = inverse.render_linear(truth, camera, config, fold_in(key, 999))
        target_soft = inverse.render_linear(
            truth, camera, config.replace(silhouette_softness=softness), fold_in(key, 999),
        )
    perturbed = truth.replace(
        centers=truth.centers + torch.tensor(
            [[0.0, 0, 0], [0.1, 0.08, 0], [-0.08, 0.08, 0], [0.08, -0.04, 0]], device=dev),
        albedo=torch.clamp(truth.albedo + 0.2, 0.05, 0.95),
    )
    mask = torch.zeros_like(truth.centers)
    mask[1:] = 1.0

    def cb(phase):
        def inner(i, loss, params):
            if i % 10 == 0:
                meter.emit({"phase": phase, "step": i, "loss": loss})
        return inner

    def snap_kw(phase):
        if not args.snapshot:
            return {}
        return dict(snapshot_path=f"{args.snapshot}.{phase}.npz",
                    snapshot_every=args.snapshot_every)

    # Two-phase coordinate descent: materials first, then geometry with soft
    # silhouettes (fitting both at once lets the gradient noise walk the
    # geometry while the albedo error dominates the loss).
    s1 = max(args.steps // 2, 1)
    stage1, losses1 = inverse.fit(
        perturbed, target_hard, camera, config, key, steps=s1, lr=args.lr,
        leaves=("albedo",), callback=cb("invert_albedo"), device=dev, **snap_kw("albedo"),
    )
    recovered, losses2 = inverse.fit(
        stage1, target_soft, camera, config, fold_in(key, 1),
        steps=args.steps - s1, lr=min(args.lr, 1e-2),
        leaves=("centers",), softness=softness, param_mask={"centers": mask},
        callback=cb("invert_centers"), device=dev, **snap_kw("centers"),
    )
    losses = losses1 + losses2
    meter.emit({
        "phase": "invert_done",
        "loss_first": losses[0], "loss_last": losses[-1],
        "center_err_before": float((perturbed.centers - truth.centers).abs().max()),
        "center_err_after": float((recovered.centers - truth.centers).abs().max()),
    })
    if args.output:
        with torch.no_grad():
            img = inverse.render_linear(recovered, camera, config, key)
        io.save_image(args.output, (torch.clamp(img, 0, 1) ** 0.5).cpu().numpy())
    return 0


def cmd_info(args) -> int:
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: cuda x{len(names)}: {names}")
    else:
        print("devices: no CUDA device (run with --device cpu)")
    print("presets:")
    for p in PRESETS.values():
        c = p.config
        print(f"  {p.name:16s} {c.width}x{c.height} @{c.spp}spp depth={c.max_depth}"
              f"  - {p.description}")
    return 0


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain versions)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simplepathtracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset scene")
    r.add_argument("--preset", choices=sorted(PRESETS), default="cover")
    r.add_argument("-o", "--output", default=None, help="output image (.png/.bmp)")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--max-depth", dest="max_depth", type=int)
    r.add_argument("--spp-chunk", dest="spp_chunk", type=int)
    r.add_argument("--no-pallas", action="store_true",
                   help="the plain wavefront route instead of the persistent kernel")
    r.add_argument(
        "--balance", dest="balance_probe_spp", type=int, metavar="PROBE_SPP",
        help="adaptive lane balancing: probe spp before cost-sorted assignment",
    )
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--scene-seed", type=int, default=0)
    r.add_argument("--snapshot", default=None, help="snapshot file (.npz)")
    r.add_argument("--snapshot-every", type=int, default=None, metavar="SPP")
    r.add_argument("--preview", default=None, help="write partial image each chunk")
    r.add_argument(
        "--http-preview", dest="http_preview", type=int, default=None,
        metavar="PORT", nargs="?", const=0,
        help="serve a live progressive preview over HTTP (0 = random port)",
    )
    r.add_argument("--resume", default=None, help="resume from snapshot")
    r.add_argument("--trace", default=None,
                   help="torch.profiler trace directory (writes trace.json)")
    r.add_argument("-q", "--quiet", action="store_true")
    _add_device(r)
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("invert", help="inverse-rendering demo")
    i.add_argument(
        "--preset", choices=sorted(PRESETS), default=None,
        help="preset-scale fit: perturb this preset scene's albedos and "
             "recover them (default: the small three-sphere two-phase demo)",
    )
    i.add_argument(
        "--grad-regen", dest="grad_regen", action="store_true",
        help="use the regeneration gradient kernels",
    )
    i.add_argument(
        "--grad-accum", dest="grad_accum", type=int, default=0, metavar="K",
        help="split each step's spp into K independent-pair gradient "
             "groups (auto-picked when spp exceeds the streamed-idx "
             "capacity; see inverse.make_accum_grad_step)",
    )
    i.add_argument("--steps", type=int, default=60)
    i.add_argument("--lr", type=float, default=2e-2)
    i.add_argument("--width", type=int)
    i.add_argument("--height", type=int)
    i.add_argument("--spp", type=int)
    i.add_argument("--max-depth", dest="max_depth", type=int)
    i.add_argument("--scene-seed", type=int, default=0)
    i.add_argument("--seed", type=int, default=0)
    i.add_argument(
        "--snapshot", default=None, metavar="PATH",
        help="fit-state snapshot prefix (writes PATH.albedo.npz / "
             "PATH.centers.npz; resumes from them if present)",
    )
    i.add_argument("--snapshot-every", dest="snapshot_every", type=int, default=10)
    i.add_argument(
        "--balance", action="store_true",
        help="probe per-pixel cost and fit in cost-balanced pixel order "
             "(values unchanged: randomness is keyed by global pixel id). "
             "Off by default: on an H100 80GB HBM3 at 700 W the balanced "
             "cover hard-fit step ran 1.9-2.0%% slower (chip_smoke.py phase 10)",
    )
    i.add_argument(
        "--no-balance", dest="no_balance", action="store_true",
        help="disable cost-balanced pixel order (overrides --balance)",
    )
    i.add_argument("-o", "--output", default=None)
    i.add_argument("-q", "--quiet", action="store_true")
    _add_device(i)
    i.set_defaults(fn=cmd_invert)

    n = sub.add_parser("info", help="list devices and presets")
    n.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
