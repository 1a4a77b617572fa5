"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py               # what the checks below need
    python3 chip_smoke.py --sweep       # also time bank counts and balancing

Builds the CUDA kernels from the sources in the checkout (one nvcc per
source, in parallel) and holds each against its plain PyTorch version on
the card.  Phases 1-4 serve the forward render: the persistent kernel
against its plain version, balancing, the full-width ``cover`` preset
(1200x800, 100 spp, depth 10, thin-lens defocus) through ``render()``, and
2,048 random pixels of that frame re-rendered by the plain version (bit for
bit).  Phases 5-6 serve inverse rendering: the regeneration forward (both
modes), re-forward, backward and bucket kernels against their plain
versions at small shapes, through ``pixel_loss`` on 2,048 random pixels of
the full frame, and kernel by kernel at one full-width chunk (2,048 random
lanes against the plain versions, the bucket against ``index_add_``); the
regen forward against the persistent kernel over the full frame, with
every sample also run alone to find the paths that differ; and ``fit`` on
the full frame (albedo and sky fitted, centers and radii frozen), whose
loss must fall and which must run through the kernels only.
Every phase raises on failure.  The last lines are one JSON object with the
kernels' numbers and one with the device; without CUDA the script exits
non-zero and prints neither.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import torch

# One sphere test is 20 FP32 operations (csrc/persistent.cu, closest_hit).
FLOPS_PER_SPHERE_TEST = 20
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Pixels of the full cover frame that phases 4 and 6 also run through the
# plain versions.
N_CHECK_PIXELS = 2048
# JAX's bound for regen gradients (tests/test_pallas_grad_regen.py).
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6
# Backward kernel against its plain version: expected bit-exact.
BWD_RTOL = 1e-5
# Bucket against index_add_: atomics add in a changing order.  At full
# width an entry sums up to ~2e7 rows.  A float32 sum of n rows in any
# order errs by at most (n - 1) roundings of the sum of their magnitudes;
# against a float64 index_add_ the kernel may be off by BUCKET_SUM_ROUNDINGS
# of them (the kernel's blocked sums err by about 1; a float32 index_add_,
# one long chain of atomics per entry, by 5 to 30 on the cover chunk's rows;
# a missing block or row still shows).
BUCKET_RTOL, BUCKET_ATOL_REL = 1e-5, 1e-7
F32_EPS = 2.0 ** -23
BUCKET_SUM_ROUNDINGS = 8
# Operations per lane-iteration of the backward (bounce forward ~150, its
# adjoint ~250 FP32 operations; threefry's integer work not counted).
BWD_OPS_PER_ITER = 400
# Residual planes of one lane-iteration (csrc/grad_regen.cu), 4 B each.
N_RES_PLANES = 25
N_CT_PLANES = 9
# Regen forward against the persistent kernel (different hit rebuild, so
# knife-edge winners may flip): |d| > 1e-4 on fewer than this share of
# channels at this spp (tests/test_pallas_bounce.py:44-46).  A path whose
# radiance differs by more than FLIP_TOL in a channel, or whose bounce
# count differs, is a flipped path.
KNIFE_EDGE_SHARE, KNIFE_EDGE_SPP = 0.005, 8
FLIP_TOL = 1e-4
# The fit of phase 6: Adam steps timed, learning rate, start point.
FIT_STEPS, FIT_LR = 3, 2e-2
ALBEDO_START, SKY_START = 0.6, 0.8

_SRC = "simplepathtracer_tpu_torch/csrc/"
_JAX = "simplepathtracer_tpu/ops/"
# (name, source, TPU kernel replaced) of the gradient path's kernels.
GRAD_KERNELS = (
    ("regen_fwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:133"),
    ("regen_refwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:1095"),
    ("regen_bwd", _SRC + "grad_regen.cu", _JAX + "pallas_grad_regen.py:462"),
    ("bucket", _SRC + "bucket.cu", _JAX + "pallas_bucket.py:50"),
)


def gamma_image(sums, spp):
    return torch.clamp(sums / spp, 0.0, 1.0) ** 0.5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gb(dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")


def grad_wrappers():
    """{name: (kernel wrapper, plain version)} of the gradient path."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    return {
        "regen_fwd": (gr.regen_forward, gr.regen_fwd_reference),
        "regen_refwd": (gr.regen_refwd, gr.regen_refwd_reference),
        "regen_bwd": (gr.regen_backward, gr.regen_bwd_reference),
        "bucket": (bucket.bucket_cols, bucket.bucket_cols_reference),
    }


def reset_counts(wrappers):
    for kernel, plain in wrappers.values():
        kernel.launches = 0
        plain.calls = 0


@contextlib.contextmanager
def plain_route():
    """Run the gradient path through the plain versions on the card: the
    wrappers launch their kernels for every CUDA tensor, so the plain
    versions stand in for them here.  Raises unless every plain version
    ran inside and no kernel launched (the counts are reset on entry)."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    wrappers = grad_wrappers()
    saved = (gr.regen_forward, gr.regen_refwd, gr.regen_backward, bucket.bucket_cols)
    gr.regen_forward = gr.regen_fwd_reference
    gr.regen_refwd = gr.regen_refwd_reference
    gr.regen_backward = gr.regen_bwd_reference
    bucket.bucket_cols = bucket.bucket_cols_reference
    reset_counts(wrappers)
    try:
        yield
    finally:
        gr.regen_forward, gr.regen_refwd, gr.regen_backward, bucket.bucket_cols = saved
    launches = {k: kern.launches for k, (kern, _) in wrappers.items()}
    calls = {k: plain.calls for k, (_, plain) in wrappers.items()}
    if any(launches.values()) or not all(calls.values()):
        raise RuntimeError(f"plain route did not take the plain versions only: kernel "
                           f"launches {launches}, plain calls {calls}")


def equal_on_alive(a, b, alive):
    """Residual planes a, b ([k, n_iter, n_lanes]) bit-identical where
    ``alive``; alive and idx (float plane 9, int plane 3) everywhere."""
    (af, ai), (bf, bi) = a, b
    return (torch.equal(af[:, alive], bf[:, alive]) and torch.equal(ai[:, alive], bi[:, alive])
            and torch.equal(af[9], bf[9]) and torch.equal(ai[3], bi[3]))


def normwise_err(got, want):
    """max|got - want| / max|want| (0 when both are 0)."""
    d = (got - want).abs().max().item()
    m = want.abs().max().item()
    return d / m if m > 0 else d, d


def grads_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Every leaf within |d| <= atol + rtol |want|; (ok, max |d|)."""
    ok, worst = True, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        worst = max(worst, d.max().item())
        ok = ok and bool((d <= atol + rtol * w.abs()).all()) and bool(torch.isfinite(g).all())
    return ok, worst


def loss_and_grads(tpt, scene, target, cam, cfg, key, dev, pixel_perm=None):
    params, _ = tpt.split_params(scene)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = tpt.pixel_loss(params, scene, target, cam, cfg, key, pixel_perm=pixel_perm, device=dev)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def phase5_kernels(tpt, dev):
    """The gradient kernels against their plain versions at small shapes.
    Returns ({kernel: max |d| seen}, {kernel: plain ms at the cover shape},
    {kernel: kernel ms at the cover shape}, the cover shape)."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

    trio_cam = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)
    cases = [
        ("cover", tpt.compact_scene(tpt.cover_scene(0, device=dev)),
         tpt.PRESETS["cover"].camera_fn(dev), 64, 32, 4, 10, 0),
        ("three_sphere_plane", tpt.with_ground_plane(tpt.three_sphere_scene(device=dev)),
         tpt.make_camera(**trio_cam, device=dev), 48, 24, 8, 10, 2),
        ("reference_37x13", tpt.reference_scene(device=dev),
         tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev),
         37, 13, 4, 10, 0),
    ]
    errs = {name: 0.0 for name, _, _ in GRAD_KERNELS}
    plain_ms, kernel_ms, shape = {}, {}, None
    gen = torch.Generator().manual_seed(1)
    key = tpt.make_key(3)
    for name, scene, cam, w, h, spp, depth, rr in cases:
        cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr)
        inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
        pix = torch.arange(w * h, device=dev)
        call = gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key, pix,
                             n_samples=spp, max_depth=depth, width=w, height=h,
                             rr_start_depth=rr)
        tag = f"phase5 {name} {w}x{h} spp={spp} depth={depth} rr={rr}"

        # Recording forward, both modes: bit-exact.
        rad_k, cnt_k, res_k = gr.regen_forward(call, 0, True)
        sync(dev)
        rad_p, cnt_p, res_p = gr.regen_fwd_reference(call, 0, True)
        alive = res_p[0][9] > 0
        full_ok = (torch.equal(rad_k, rad_p) and torch.equal(cnt_k, cnt_p)
                   and equal_on_alive(res_k, res_p, alive))
        radi_k, cnti_k, pk_k = gr.regen_forward(call, 0, False)
        sync(dev)
        radi_p, cnti_p, pk_p = gr.regen_fwd_reference(call, 0, False)
        idx_ok = (torch.equal(radi_k, radi_p) and torch.equal(cnti_k, cnti_p)
                  and torch.equal(pk_k, pk_p) and torch.equal(radi_k, rad_k))
        errs["regen_fwd"] = max(errs["regen_fwd"], (rad_k - rad_p).abs().max().item(),
                                (radi_k - radi_p).abs().max().item())
        print(f"{tag}: regen fwd full {'bit-exact' if full_ok else 'DIFFERS'}, idx-only "
              f"{'bit-exact' if idx_ok else 'DIFFERS'} (n_iter={call.n_iter}, "
              f"iterations={cnt_k.sum().item():.0f}, alive entries={alive.sum().item()})")
        if not (full_ok and idx_ok):
            raise RuntimeError(f"{tag}: regen forward kernel disagrees with its plain version")

        # Scan-free re-forward from the kernel's packed words: the planes of
        # the recording forward, bit for bit.
        res_r = gr.regen_refwd(call, 0, pk_k)
        sync(dev)
        refwd_ok = equal_on_alive(res_r, res_k, alive)
        res_rp = gr.regen_refwd_reference(call, 0, pk_k)
        refwd_ok = refwd_ok and equal_on_alive(res_rp, res_k, alive)
        errs["regen_refwd"] = max(errs["regen_refwd"],
                                  (res_r[0][:, alive] - res_k[0][:, alive]).abs().max().item())
        print(f"{tag}: re-forward planes {'bit-exact' if refwd_ok else 'DIFFER'} on alive entries")
        if not refwd_ok:
            raise RuntimeError(f"{tag}: re-forward kernel disagrees with the recording forward")

        # Backward over the same residuals: expected bit-exact.
        ct = torch.randn((w * h, 3), generator=gen).to(dev) * 1e-3
        ctp_k, part_k = gr.regen_backward(call, 0, res_k[0], res_k[1], ct)
        sync(dev)
        ctp_p, part_p = gr.regen_bwd_reference(call, 0, res_k[0], res_k[1], ct)
        (e1, d1), (e2, d2) = normwise_err(ctp_k, ctp_p), normwise_err(part_k, part_p)
        errs["regen_bwd"] = max(errs["regen_bwd"], d1, d2)
        print(f"{tag}: backward cotangent planes rel {e1:.3e} (max|d| {d1:.3e}), "
              f"partials rel {e2:.3e} (max|d| {d2:.3e})")
        if not (e1 <= BWD_RTOL and e2 <= BWD_RTOL and torch.isfinite(ctp_k).all()):
            raise RuntimeError(f"{tag}: backward kernel disagrees with its plain version")

        # Bucket against index_add_.
        s = call.n_spheres
        d_k = bucket.bucket_cols(ctp_k, res_k[1][3], s)
        sync(dev)
        d_p = bucket.bucket_cols_reference(ctp_k, res_k[1][3], s)
        tol = BUCKET_RTOL * d_p.abs() + BUCKET_ATOL_REL * ctp_k.abs().max()
        diff = (d_k - d_p).abs()
        errs["bucket"] = max(errs["bucket"], diff.max().item())
        print(f"{tag}: bucket max|d| {diff.max().item():.3e} (table max {d_p.abs().max().item():.3e})")
        if not bool((diff <= tol).all()):
            raise RuntimeError(f"{tag}: bucket kernel disagrees with index_add_")

        # pixel_loss through the kernels against the plain route, streamed
        # over 2 chunks where spp allows.
        gcfg = cfg.replace(use_pallas_grad=True, grad_regen=True, spp_chunk=spp // 2)
        target = torch.full((h, w, 3), 0.25, device=dev)
        l_k, g_k = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
        with plain_route():
            l_p, g_p = loss_and_grads(tpt, scene, target, cam, gcfg, key, dev)
        ok, worst = grads_close(list(g_k.values()), list(g_p.values()))
        rel = abs(l_k.item() - l_p.item()) / abs(l_p.item())
        print(f"{tag}: pixel_loss kernels {l_k.item():.9g} plain {l_p.item():.9g} (rel {rel:.2e}), "
              f"gradients max|d| {worst:.3e} over {len(g_k)} leaves")
        if not (ok and rel <= 1e-6):
            raise RuntimeError(f"{tag}: pixel_loss through the kernels disagrees with the plain route")

        if name == "cover" and dev.type == "cuda":
            shape = f"{w}x{h}x{spp}spp depth {depth}"
            bwd_args = (call, 0, res_k[0], res_k[1], ct)
            for kname, kern, plain, args in (
                ("regen_fwd", gr.regen_forward, gr.regen_fwd_reference, (call, 0, False)),
                ("regen_refwd", gr.regen_refwd, gr.regen_refwd_reference, (call, 0, pk_k)),
                ("regen_bwd", gr.regen_backward, gr.regen_bwd_reference, bwd_args),
                ("bucket", bucket.bucket_cols, bucket.bucket_cols_reference,
                 (ctp_k, res_k[1][3], s)),
            ):
                plain_ms[kname] = cuda_ms(lambda: plain(*args), reps=2)
                kernel_ms[kname] = cuda_ms(lambda: kern(*args), reps=10)
            print(f"phase5 cover {shape}: plain ms {plain_ms}, kernel ms {kernel_ms}")
    return errs, plain_ms, kernel_ms, shape


def phase6_main(tpt, dev, scene, cam, cfg, key, persistent_sums, persistent_counts, wrappers):
    """The gradient path at the main path's shapes: kernels against the
    plain route on random pixels, the regen forward against the persistent
    kernel's full frame, a full-frame gradient, and ``fit``.  Returns what
    the report needs."""
    from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr
    from simplepathtracer_tpu_torch.ops.persistent import render_block_persistent
    from simplepathtracer_tpu_torch.render import _persistent_args, stream_capacity_spp

    out = {"errs": {}}
    gcfg = tpt.grad_safe_config(cfg, dev)
    chunk = gcfg.spp_chunk or cfg.spp
    n_chunks = cfg.spp // chunk
    cap = stream_capacity_spp(gcfg, scene)
    print(f"phase6 route: regen={gcfg.use_pallas_grad and gcfg.grad_regen}, spp_chunk={chunk}, "
          f"chunks={n_chunks}, streamed-idx capacity {cap} spp")
    if not (gcfg.grad_regen and n_chunks > 1 and cap >= cfg.spp and cfg.spp % chunk == 0):
        raise RuntimeError("phase6: the main path does not take the streamed-idx route")
    out.update(chunk=chunk, n_chunks=n_chunks)

    # The target is the true scene's render; the fit starts from dimmed
    # albedo and sky.
    target = tpt.render_linear(scene, cam, cfg, tpt.fold_in(key, 1000))
    start = scene.replace(albedo=scene.albedo * ALBEDO_START,
                          sky_lo=scene.sky_lo * SKY_START, sky_hi=scene.sky_hi * SKY_START)

    # (a) Gradients on random pixels of the full frame: kernels against the
    # plain versions on the card, same key, spp and chunking.
    gen = torch.Generator().manual_seed(2)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    t0 = time.perf_counter()
    l_k, g_k = loss_and_grads(tpt, start, target, cam, cfg, key, dev, pixel_perm=rows)
    sync(dev)
    t1 = time.perf_counter()
    with plain_route():
        l_p, g_p = loss_and_grads(tpt, start, target, cam, cfg, key, dev, pixel_perm=rows)
    sync(dev)
    t2 = time.perf_counter()
    ok, worst = grads_close(list(g_k.values()), list(g_p.values()))
    print(f"phase6 {N_CHECK_PIXELS} random pixels, {cfg.spp} spp in {n_chunks} chunks: loss kernels "
          f"{l_k.item():.9g} plain {l_p.item():.9g}, gradients max|d| {worst:.3e} "
          f"(kernels {t1 - t0:.2f} s, plain {t2 - t1:.2f} s)")
    if not (torch.equal(l_k, l_p) and ok):
        raise RuntimeError("phase6: pixel_loss through the kernels disagrees with the plain route")
    out["errs"]["grad_random_pixels"] = worst

    # (b) Regen forward over the full frame against the persistent kernel.
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)

    def regen_call(n_samples):
        return gr.regen_call(inputs[:11], inputs[11], inputs[12], cam19, key, pix,
                             n_samples=n_samples, max_depth=cfg.max_depth, width=cfg.width,
                             height=cfg.height, t_min=cfg.t_min, t_max=cfg.t_max,
                             rr_start_depth=cfg.rr_start_depth)

    pargs = _persistent_args(scene, cam, cfg)

    def persistent(sample_offset, n_samples):
        return render_block_persistent(pix, *pargs, key, sample_offset, n_samples, cfg.max_depth,
                                       cfg.width, cfg.height, t_min=cfg.t_min, t_max=cfg.t_max,
                                       rr_start_depth=cfg.rr_start_depth, return_counts=True)

    out["errs"]["regen_vs_persistent"] = knife_edge(
        gr, regen_call, persistent, cfg, chunk, persistent_sums, persistent_counts)

    # (c) One full-frame gradient: every leaf finite and nonzero.
    reset_peak(dev)
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(tpt, start, target, cam, cfg, key, dev)
    sync(dev)
    out["grad_s"] = time.perf_counter() - t0
    out["grad_peak_gb"] = peak_gb(dev)
    summary = {k: f"{g.abs().max().item():.3e}" for k, g in grads.items()}
    print(f"phase6 full-frame gradient: loss {loss.item():.6g}, {out['grad_s']:.3f} s, peak "
          f"{out['grad_peak_gb']:.2f} GB, max|grad| per leaf {summary}")
    for k, g in grads.items():
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise RuntimeError(f"phase6: gradient of {k} is not finite or is zero")

    # (d) fit: one warm step, then FIT_STEPS timed steps through the kernels
    # only; centers and radii frozen.
    mask = {"centers": torch.zeros_like(scene.centers), "radii": torch.zeros_like(scene.radii)}
    fit_kw = dict(lr=FIT_LR, softness=0.0, param_mask=mask, device=dev)
    tpt.fit(start, target, cam, cfg, key, steps=1, **fit_kw)
    sync(dev)
    reset_counts(wrappers)
    reset_peak(dev)
    t0 = time.perf_counter()
    fitted, losses = tpt.fit(start, target, cam, cfg, key, steps=FIT_STEPS, **fit_kw)
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / FIT_STEPS
    out["fit_peak_gb"] = peak_gb(dev)
    out["launches"] = {k: kern.launches for k, (kern, _) in wrappers.items()}
    out["plain_calls"] = {k: plain.calls for k, (_, plain) in wrappers.items()}
    out["losses"] = losses
    err_alb = (fitted.albedo - scene.albedo).abs().mean().item()
    err_alb0 = (start.albedo - scene.albedo).abs().mean().item()
    print(f"phase6 fit {FIT_STEPS} steps (lr {FIT_LR}): losses {losses}, {out['step_s']:.3f} s/step, "
          f"{cfg.num_pixels * cfg.spp / out['step_s'] / 1e6:.2f} Mpaths/s fwd+bwd, peak "
          f"{out['fit_peak_gb']:.2f} GB, mean|albedo - truth| {err_alb0:.4f} -> {err_alb:.4f}, "
          f"launches {out['launches']}, plain calls {out['plain_calls']}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise RuntimeError("phase6: the fit's loss did not fall")

    # (e) Each kernel at the main path's chunk shape: against its plain
    # version on the random pixels of (a), timed, and bounded.
    if dev.type == "cuda":
        out.update(full_width_kernels(gr, bucket, regen_call(chunk), scene, cfg, rows))
    return out


def knife_edge(gr, regen_call, persistent, cfg, chunk, persistent_sums, persistent_counts):
    """The regen forward against the persistent kernel over the full frame,
    at KNIFE_EDGE_SPP and at the main path's spp in its chunks; returns
    max |d| of the latter.

    The two rebuild the hit normal in different ops (bounce_tile's 1/sqrt,
    the persistent kernel's rsqrt), so a path at a silhouette may take
    another turn, and one such path among a pixel's samples moves its mean
    past 1e-4.  To show that this is the whole cause, every sample also
    runs alone through both kernels: a path is flipped where its radiance
    differs by more than FLIP_TOL in a channel or its bounce count differs.
    Raises unless: the per-sample runs sum to the multi-sample frames; the
    8-spp frame is inside the repo's knife-edge bound
    (tests/test_pallas_bounce.py:44-46) and the full-spp frame inside its
    depth-10 regen bound (tests/test_pallas_grad_regen.py:215-216); every
    channel off by more than 1e-4 lies on a pixel with a flipped path; and
    the flipped paths of the first KNIFE_EDGE_SPP samples are as many as
    the rate over all samples predicts (5 sigma, Poisson)."""
    spp, p = cfg.spp, cfg.num_pixels
    sums_k = torch.zeros_like(persistent_sums)
    cnt_k = torch.zeros_like(persistent_counts)
    call = regen_call(chunk)
    for off in range(0, spp, chunk):
        r, c, _ = gr.regen_forward(call, off, False)
        sums_k += r
        cnt_k += c
    sums8_k, cnt8_k, _ = gr.regen_forward(regen_call(KNIFE_EDGE_SPP), 0, False)
    sums8_q, cnt8_q = persistent(0, KNIFE_EDGE_SPP)

    call1 = regen_call(1)
    flips = []
    flipped = torch.zeros(p, dtype=torch.bool, device=persistent_sums.device)
    edges = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
    hist = torch.zeros(len(edges), dtype=torch.int64, device=flipped.device)
    one_k, one_q = torch.zeros_like(sums_k), torch.zeros_like(sums_k)
    one_ck, one_cq = torch.zeros_like(cnt_k), torch.zeros_like(cnt_k)
    for s in range(spp):
        r_k, c_k, _ = gr.regen_forward(call1, s, False)
        r_q, c_q = persistent(s, 1)
        d = (r_k - r_q).abs().amax(dim=1)
        f = (d > FLIP_TOL) | (c_k != c_q)
        flips.append(f.sum())
        flipped |= f
        if s + 1 == KNIFE_EDGE_SPP:
            flipped8 = flipped.clone()
        hist += torch.stack([(d > e).sum() for e in edges])
        one_k += r_k
        one_q += r_q
        one_ck += c_k
        one_cq += c_q
    flips = torch.stack(flips).double().cpu()

    def decomposes(one, full):
        return bool(((one - full).abs() <= 1e-4 * (full.abs() + 1.0)).all())

    sums_ok = (decomposes(one_k, sums_k) and decomposes(one_q, persistent_sums)
               and torch.equal(one_ck, cnt_k) and torch.equal(one_cq, persistent_counts))

    def frame(sums_a, sums_b, cnt_a, cnt_b, n, flip_pix):
        d = ((sums_a - sums_b) / n).abs()
        over = d > 1e-4
        unequal = cnt_a != cnt_b
        return dict(mean=d.mean().item(), share=over.float().mean().item(),
                    share2=(d > 1e-2).float().mean().item(), max=d.max().item(),
                    unexplained=(over & ~flip_pix[:, None]).sum().item(),
                    over_on_unequal=(over & unequal[:, None]).sum().item() / max(1, over.sum().item()),
                    unequal_pix=unequal.float().mean().item(),
                    flip_pix=flip_pix.float().mean().item())

    f8 = frame(sums8_k, sums8_q, cnt8_k, cnt8_q, KNIFE_EDGE_SPP, flipped8)
    fa = frame(sums_k, persistent_sums, cnt_k, persistent_counts, spp, flipped)
    rate = flips.sum().item() / (spp * p)
    expect8 = flips.sum().item() * KNIFE_EDGE_SPP / spp
    got8 = flips[:KNIFE_EDGE_SPP].sum().item()
    rate_ok = abs(got8 - expect8) <= 5.0 * math.sqrt(expect8) + 1.0
    for n, f in ((KNIFE_EDGE_SPP, f8), (spp, fa)):
        print(f"phase6 regen forward vs persistent kernel, full frame at {n} spp: mean|d| "
              f"{f['mean']:.3e}, share |d| > 1e-4 {f['share']:.5f}, share |d| > 1e-2 "
              f"{f['share2']:.6f}, max|d| {f['max']:.3e}; pixels with a flipped path "
              f"{f['flip_pix']:.5f} (1 - (1 - rate)^spp = {1 - (1 - rate) ** n:.5f}), channels over "
              f"1e-4 off those pixels {f['unexplained']}; pixels with unequal counts "
              f"{f['unequal_pix']:.5f}, share of the channels over 1e-4 on them "
              f"{f['over_on_unequal']:.3f}")
    print(f"phase6 per-sample paths: flipped per sample mean {flips.mean().item():.1f} (rate "
          f"{rate:.3e} of paths), first {KNIFE_EDGE_SPP} samples {got8:.0f} against {expect8:.1f} "
          f"expected, min/max per sample {flips.min().item():.0f}/{flips.max().item():.0f}; paths "
          f"with max-channel |d| over {dict(zip(edges, hist.tolist()))}; per-sample runs sum to "
          f"the frames: {sums_ok}")
    if not (sums_ok and torch.isfinite(sums_k).all() and f8["mean"] < 1e-4
            and f8["share"] < KNIFE_EDGE_SHARE and fa["mean"] < 1e-4 and fa["share2"] < 1e-3
            and f8["unexplained"] == 0 and fa["unexplained"] == 0 and rate_ok):
        raise RuntimeError("phase6: regen forward disagrees with the persistent kernel")
    return fa["max"]


def full_width_kernels(gr, bucket, call, scene, cfg, rows):
    """Each gradient kernel at the main path's chunk shape (the true scene's
    tables, the chunk at sample offset 0).  With one bank, lane = pixel and
    a lane's outputs depend on its pixel alone, so the kernels' outputs on
    the lanes ``rows`` must equal the plain versions run on those pixels
    (same key and sample offset); the bucket's table over all the chunk's
    rows is held against a float64 index_add_.  Also the CUDA-event ms of
    each kernel, its bound from this run's data, and index_add_'s time on
    the bucket's rows.  Raises on a mismatch."""
    if call.n_banks != 1:
        raise RuntimeError("full_width_kernels needs one bank (lane = pixel)")
    b, n, p = call.n_iter, call.n_lanes, cfg.num_pixels
    sub = call._replace(pixel_ids=rows.to(torch.int32), n_lanes=rows.numel())
    cols = rows.to(torch.int64)
    errs = {}
    tag = f"kernel at {cfg.width}x{cfg.height}x{call.n_samples}spp, {rows.numel()} random lanes:"
    live = ((scene.radii.abs() > 1e-3) & (scene.centers[:, 1] > -1e6)).sum().item()
    ms, bound = {}, {}

    ms["regen_fwd"] = cuda_ms(lambda: gr.regen_forward(call, 0, False), reps=2)
    rad, cnt, packed = gr.regen_forward(call, 0, False)
    rad_p, cnt_p, packed_p = gr.regen_fwd_reference(sub, 0, False)
    ok = (torch.equal(rad[cols], rad_p) and torch.equal(cnt[cols], cnt_p)
          and torch.equal(packed[:, cols], packed_p))
    errs["regen_fwd"] = (rad[cols] - rad_p).abs().max().item()
    print(f"{tag} regen fwd (idx-only) radiance, counts and packed words "
          f"{'bit-exact' if ok else 'DIFFER'}")
    if not ok:
        raise RuntimeError("full width: regen forward kernel disagrees with its plain version")
    iters = cnt.double().sum().item()
    res = {"iters_chunk": iters, "n_iter": b, "n_lanes": n}
    # Sphere tests; the packed words and sums are a few hundred MB.
    ops = iters * live * FLOPS_PER_SPHERE_TEST
    nbytes = packed.numel() * 4 + p * (4 + 12)
    bound["regen_fwd"] = (ops / PEAK_FP32, nbytes / PEAK_BYTES)
    del rad, cnt

    ms["regen_refwd"] = cuda_ms(lambda: gr.regen_refwd(call, 0, packed), reps=2)
    resf, resi = gr.regen_refwd(call, 0, packed)
    resf_p, resi_p = gr.regen_refwd_reference(sub, 0, packed_p)
    alive = resf_p[9] > 0
    ok = equal_on_alive((resf[:, :, cols], resi[:, :, cols]), (resf_p, resi_p), alive)
    errs["regen_refwd"] = (resf[:, :, cols][:, alive] - resf_p[:, alive]).abs().max().item()
    print(f"{tag} re-forward planes {'bit-exact' if ok else 'DIFFER'} on "
          f"{alive.sum().item()} alive entries")
    if not ok:
        raise RuntimeError("full width: re-forward kernel disagrees with its plain version")
    # Reads the packed words; writes 25 planes on live entries, alive and
    # idx on the rest.
    nbytes = packed.numel() * 4 + iters * N_RES_PLANES * 4 + (b * n - iters) * 8
    bound["regen_refwd"] = (0.0, nbytes / PEAK_BYTES)
    del packed

    gen = torch.Generator().manual_seed(3)
    ct = (torch.randn((p, 3), generator=gen) * 1e-6).to(call.pixel_ids.device)
    ms["regen_bwd"] = cuda_ms(lambda: gr.regen_backward(call, 0, resf, resi, ct), reps=2)
    ct_planes, part = gr.regen_backward(call, 0, resf, resi, ct)
    ct_p, part_p = gr.regen_bwd_reference(sub, 0, resf_p, resi_p, ct[cols])
    (e1, d1), (e2, d2) = normwise_err(ct_planes[:, :, cols], ct_p), normwise_err(part[:, cols], part_p)
    errs["regen_bwd"] = max(d1, d2)
    print(f"{tag} backward cotangent planes rel {e1:.3e} (max|d| {d1:.3e}), partials rel "
          f"{e2:.3e} (max|d| {d2:.3e})")
    if not (e1 <= BWD_RTOL and e2 <= BWD_RTOL and torch.isfinite(ct_planes).all()):
        raise RuntimeError("full width: backward kernel disagrees with its plain version")
    # Reads 25 planes on live entries and alive on the rest; writes the 9
    # cotangent planes whole.
    nbytes = iters * N_RES_PLANES * 4 + (b * n - iters) * 4 + b * n * N_CT_PLANES * 4
    bound["regen_bwd"] = (iters * BWD_OPS_PER_ITER / PEAK_FP32, nbytes / PEAK_BYTES)
    del resf, part, resf_p, resi_p

    idx = resi[3]
    s = call.n_spheres
    ms["bucket"] = cuda_ms(lambda: bucket.bucket_cols(ct_planes, idx, s), reps=3)
    d_k = bucket.bucket_cols(ct_planes, idx, s)
    flat = idx.reshape(-1)
    keep = (flat >= 0) & (flat < s)
    n_rows = keep.sum().item()
    # Reads every index and the 9 cotangents of the rows that name a sphere.
    bound["bucket"] = (n_rows * N_CT_PLANES / PEAK_FP32,
                       (flat.numel() * 4 + n_rows * N_CT_PLANES * 4) / PEAK_BYTES)
    idx_keep = flat[keep].to(torch.int64)
    src = ct_planes.reshape(N_CT_PLANES, -1)[:, keep].T.contiguous()
    del resi, ct_planes, idx, flat, keep
    table = torch.zeros((s, N_CT_PLANES), dtype=torch.float32, device=src.device)
    res["library_ms_bucket"] = cuda_ms(lambda: table.index_add_(0, idx_keep, src), reps=3)
    lib = torch.zeros_like(table).index_add_(0, idx_keep, src)
    ref = torch.zeros((s, N_CT_PLANES), dtype=torch.float64, device=src.device)
    ref.index_add_(0, idx_keep, src.double())
    mag = torch.zeros_like(ref).index_add_(0, idx_keep, src.abs().double())
    tol = (BUCKET_RTOL * ref.abs() + BUCKET_ATOL_REL * src.abs().max().double()
           + BUCKET_SUM_ROUNDINGS * F32_EPS * mag)
    err_k = (d_k.double() - ref).abs()
    err_l = (lib.double() - ref).abs()
    errs["bucket"] = err_k.max().item()
    print(f"{tag} bucket over all {n_rows} sphere rows against float64 index_add_: max|d| "
          f"{err_k.max().item():.3e}, max |d| / tol {(err_k / tol).max().item():.3f} (float32 "
          f"index_add_ {err_l.max().item():.3e}, {(err_l / tol).max().item():.3f}); table max "
          f"{ref.abs().max().item():.3e}")
    if not bool((err_k <= tol).all()):
        raise RuntimeError("full width: bucket kernel disagrees with index_add_")
    res["bucket_rows"] = n_rows
    res["full_width_errs"] = errs
    res["ms"] = ms
    res["bound_ms"] = {k: max(v) * 1e3 for k, v in bound.items()}
    res["bound_by"] = {k: "operations" if v[0] >= v[1] else "bytes" for k, v in bound.items()}
    for k in ms:
        print(f"kernel {k} at {cfg.width}x{cfg.height}x{call.n_samples}spp (n_iter {b}): "
              f"{ms[k]:.3f} ms, bound {res['bound_ms'][k]:.3f} ms ({res['bound_by'][k]}), "
              f"{res['bound_ms'][k] / ms[k]:.3f} of bound")
    print(f"index_add_ on the bucket's {n_rows} rows: {res['library_ms_bucket']:.3f} ms; "
          f"chunk iterations {iters:.0f}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the full cover frame for 1, 2, 4, 8, 16 banks "
                         "and with lane balancing")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    import simplepathtracer_tpu_torch as tpt
    from simplepathtracer_tpu_torch.ops import persistent
    from simplepathtracer_tpu_torch.ops.cuda_build import load_library
    from simplepathtracer_tpu_torch.render import _persistent_args

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---") or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    kernel = persistent.render_block_persistent
    plain = persistent.render_block_persistent_reference

    # ---- phase 1: kernel vs plain version --------------------------------
    trio_cam = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90)
    cases = [
        # name, scene, camera, w, h, spp, depth, rr, (mean bound, outlier bound)
        ("cover", tpt.compact_scene(tpt.cover_scene(0, device=dev)),
         tpt.PRESETS["cover"].camera_fn(dev), 64, 32, 4, 10, 0, (2.3e-4, 0.021)),
        ("three_sphere_plane", tpt.with_ground_plane(tpt.three_sphere_scene(device=dev)),
         tpt.make_camera(**trio_cam, device=dev), 48, 24, 8, 10, 2, (1e-4, 5e-3)),
        ("reference_37x13", tpt.reference_scene(device=dev),
         tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev),
         37, 13, 4, 10, 0, (1e-4, 5e-3)),
    ]
    max_abs_err = 0.0
    compare_args = None
    for name, scene, cam, w, h, spp, depth, rr, (mean_bound, out_bound) in cases:
        cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                               rr_start_depth=rr, use_pallas=True)
        tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
        pix = torch.arange(w * h, device=dev)
        call = (pix, tables, sky6, cam19, tpt.make_key(1), 0, spp, depth, w, h)
        kw = dict(rr_start_depth=rr, return_counts=True, plane7=scene.plane)
        a, ca = kernel(*call, **kw)
        torch.cuda.synchronize()
        b, cb = plain(*call, **kw)
        d = (gamma_image(a, spp) - gamma_image(b, spp)).abs()
        mean, out = d.mean().item(), (d > 1e-4).float().mean().item()
        flips = (ca != cb).float().mean().item()
        max_abs_err = max(max_abs_err, d.max().item())
        print(f"phase1 {name} {w}x{h} spp={spp} depth={depth} rr={rr} spheres={scene.num_spheres}: "
              f"mean|d|={mean:.3e} outliers={out:.4f} count_mismatch={flips:.4f} max|d|={d.max().item():.3e}")
        if not (torch.isfinite(a).all() and mean < mean_bound and out < out_bound and flips < out_bound):
            raise RuntimeError(f"phase1 {name}: kernel disagrees with its plain version")
        if name == "cover":
            compare_args = (call, kw, f"{w}x{h}x{spp}spp")

    # ---- phase 2: balancing changes no pixel -----------------------------
    scene = tpt.reference_scene(device=dev)
    cam = tpt.make_camera(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90, device=dev)
    base = dict(width=40, height=26, spp=8, max_depth=6, use_pallas=True)
    key = tpt.make_key(5)
    cfg_bal = tpt.RenderConfig(**base, balance_probe_spp=2)
    st = tpt.accumulate(tpt.init_state(cfg_bal, key, device=dev), scene, cam, cfg_bal, 8)
    cfg = tpt.RenderConfig(**base)
    st2 = tpt.accumulate(tpt.init_state(cfg, key, device=dev), scene, cam, cfg, 2)
    st2 = tpt.accumulate(st2, scene, cam, cfg, 6)
    if not torch.equal(st.accum, st2.accum):
        raise RuntimeError("phase2: balanced accumulate differs from the 2+6 schedule")
    print("phase2 balanced 40x26 8spp (probe 2): bit-identical to the 2+6 schedule")

    # ---- phase 3: the main path at full width ----------------------------
    preset = tpt.PRESETS["cover"]
    scene, cam, cfg = preset.build(0, device=dev)
    key = tpt.make_key(0)
    warm = cfg.replace(width=64, height=32, spp=2)
    tpt.render(scene, cam, warm, key)
    torch.cuda.synchronize()
    kernel.launches = 0
    plain.calls = 0
    t0 = time.perf_counter()
    img = tpt.render(scene, cam, cfg, key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain_calls = kernel.launches, plain.calls
    paths = cfg.num_pixels * cfg.spp
    print(f"phase3 cover {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth} "
          f"spheres={scene.num_spheres}: {seconds:.4f} s, {paths / seconds / 1e6:.2f} Mpaths/s, "
          f"kernel launches={launches}, plain calls={plain_calls}")
    if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all() or img.max() <= 0:
        raise RuntimeError("phase3: image is not finite or is all zero")
    if launches < 1 or plain_calls != 0:
        raise RuntimeError("phase3: the main path did not run through the kernel")
    img_mean = img.mean(dim=(0, 1)).tolist()
    print(f"phase3 image mean rgb {img_mean}")

    # ---- phase 4: kernel vs plain version at the main path's shapes -------
    # The kernel renders the whole 1200x800 frame at 100 spp; the plain
    # version renders a random subset of its pixels with the same tables,
    # key and sample ids.  Each pixel's sum is independent of the others,
    # so the rows must agree bit for bit.
    tables, sky6, cam19 = _persistent_args(scene, cam, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    full_call = (pix, tables, sky6, cam19, key, 0, cfg.spp, cfg.max_depth, cfg.width, cfg.height)
    sums, counts = kernel(*full_call, return_counts=True)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randperm(cfg.num_pixels, generator=gen)[:N_CHECK_PIXELS].to(dev)
    sub_call = (rows,) + full_call[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_sums, ref_counts = plain(*sub_call, return_counts=True)
    torch.cuda.synchronize()
    plain_main_ms = (time.perf_counter() - t0) * 1e3
    d_main = (sums[rows] - ref_sums).abs().max().item()
    count_rows = (counts[rows] != ref_counts).sum().item()
    max_abs_err = max(max_abs_err, d_main)
    print(f"phase4 cover {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth}, "
          f"{N_CHECK_PIXELS} random pixels: max|d| of sums={d_main:.3e}, "
          f"rows with unequal counts={count_rows}, plain {plain_main_ms:.1f} ms")
    if not (d_main == 0.0 and count_rows == 0):
        raise RuntimeError("phase4: kernel disagrees with its plain version at full width")

    # ---- measurements ----------------------------------------------------
    iters = counts.double().sum().item()
    ms = cuda_ms(lambda: kernel(*full_call), reps=3)
    # Dead slots (compact_scene's padding) need no test: count live spheres.
    live = ((scene.radii.abs() > 1e-3) & (scene.centers[:, 1] > -1e6)).sum().item()
    ops = iters * live * FLOPS_PER_SPHERE_TEST
    nbytes = cfg.num_pixels * (4 + 12) + scene.num_spheres * 11 * 4
    bound_ms = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    print(f"kernel cover full frame: {ms:.3f} ms, iterations {iters:.0f} "
          f"({iters / paths:.3f} per path), {live} live spheres, bound {bound_ms:.3f} ms (FP32 ops), "
          f"{bound_ms / ms:.3f} of bound")
    call, kw, shape = compare_args
    kw = dict(kw, return_counts=False)
    plain_ms = cuda_ms(lambda: plain(*call, **kw), reps=2)
    kernel_small_ms = cuda_ms(lambda: kernel(*call, **kw), reps=10)
    print(f"cover {shape}: plain {plain_ms:.3f} ms, kernel {kernel_small_ms:.3f} ms")

    if args.sweep:
        chosen = persistent.GPU_BANKS
        try:
            for nb in (1, 2, 4, 8, 16):
                persistent.GPU_BANKS = nb
                t = cuda_ms(lambda: kernel(*full_call), reps=2)
                print(f"sweep: n_banks={nb} lanes={persistent.bank_geometry(cfg.num_pixels, nb)[1]} "
                      f"{t:.3f} ms")
        finally:
            persistent.GPU_BANKS = chosen
        # Balanced schedule: 2 probe spp in image order, 98 in cost order.
        cfg_bal = cfg.replace(balance_probe_spp=2)
        for name, c in (("unbalanced", cfg), ("balanced", cfg_bal), ("unbalanced", cfg),
                        ("balanced", cfg_bal)):
            t = cuda_ms(lambda: tpt.render(scene, cam, c, key), reps=1)
            print(f"sweep: render() {name} {t:.3f} ms")

    # ---- phase 5: gradient kernels vs plain versions, small shapes --------
    grad_errs, grad_plain_ms, grad_kernel_small_ms, grad_shape = phase5_kernels(tpt, dev)

    # ---- phase 6: the gradient path at full width -------------------------
    wrappers = grad_wrappers()
    main6 = phase6_main(tpt, dev, scene, cam, cfg, key, sums, counts, wrappers)
    for name, err in main6["full_width_errs"].items():
        grad_errs[name] = max(grad_errs[name], err)
    n_chunks = main6["n_chunks"]
    per_step = {k: v / FIT_STEPS for k, v in main6["launches"].items()}
    if not (per_step["regen_fwd"] >= n_chunks and per_step["regen_refwd"] == n_chunks
            and per_step["regen_bwd"] == n_chunks and per_step["bucket"] >= n_chunks
            and not any(main6["plain_calls"].values())):
        raise RuntimeError(f"phase6: the fit did not run through the kernels only "
                           f"(launches per step {per_step}, plain calls {main6['plain_calls']})")
    print("phase6 fit: " + json.dumps({
        "shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}",
        "spp_chunk": main6["chunk"], "chunks": n_chunks, "steps": FIT_STEPS,
        "s_per_step": main6["step_s"],
        "mpaths_per_s": cfg.num_pixels * cfg.spp / main6["step_s"] / 1e6,
        "peak_gb": main6["fit_peak_gb"], "grad_s": main6["grad_s"],
        "losses": main6["losses"], "launches_per_step": per_step,
    }))

    report = {"kernels": [{
        "name": "persistent_render",
        "route": "cuda",
        "source": "simplepathtracer_tpu_torch/csrc/persistent.cu",
        "replaces": "simplepathtracer_tpu/ops/pallas_persistent.py:72",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": None,
        "ms_shape": f"{cfg.width}x{cfg.height}x{cfg.spp}spp",
        "plain_ms_shape": shape,
        "plain_ms_main_shape": plain_main_ms,
        "plain_ms_main_shape_pixels": N_CHECK_PIXELS,
        "kernel_ms_at_plain_shape": kernel_small_ms,
    }]}
    for name, source, replaces in GRAD_KERNELS:
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main6["launches"][name],
            "max_abs_err": grad_errs[name],
            "ms": main6["ms"][name],
            "plain_ms": grad_plain_ms[name],
            "bound_ms": main6["bound_ms"][name],
            "bound_by": main6["bound_by"][name],
            "library_ms": main6["library_ms_bucket"] if name == "bucket" else None,
            "ms_shape": f"{cfg.width}x{cfg.height}x{main6['chunk']}spp",
            "plain_ms_shape": grad_shape,
            "kernel_ms_at_plain_shape": grad_kernel_small_ms[name],
            "launches_over_fit_steps": FIT_STEPS,
        })
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
