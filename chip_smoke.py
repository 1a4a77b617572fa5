"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py               # what the checks below need
    python3 chip_smoke.py --sweep       # also time bank counts and balancing

Builds the CUDA kernel from the sources in the checkout, holds it against
its plain PyTorch version on the card, checks that lane balancing changes
no pixel, then renders the full-width ``cover`` preset (1200x800, 100 spp,
depth 10, 484 spheres, thin-lens defocus) through ``render()`` and checks
that the kernel, not its plain version, rendered it, and that the kernel's
full frame agrees bit for bit with the plain version on 2,048 random pixels
of it (same tables, key and sample ids 0..99).  Every phase raises on
failure.  The last lines are one JSON object with the kernel's numbers and
one with the device; without CUDA the script exits non-zero and prints
neither.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# One sphere test is 20 FP32 operations (csrc/persistent.cu, closest_hit).
FLOPS_PER_SPHERE_TEST = 20
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Pixels of the full cover frame that phase 4 also renders with the plain version.
N_CHECK_PIXELS = 2048


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
    from simplepathtracer_tpu_torch.render import _persistent_args

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = persistent.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
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
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
