// Persistent forward path tracer for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas_persistent.py:_persistent_kernel of the
// JAX package (simplepathtracer_tpu), together with the tile functions of
// ops/pallas_common.py it runs (threefry2x32, to_unit_float,
// camera_ray_tiles, closest_hit_scan, plane_override, hit_point_normal,
// sky_components, scatter_tiles).  It computes what that kernel computes:
// for every pixel position, the radiance SUM over samples
// sample_offset .. sample_offset + n_samples - 1, and optionally the number
// of bounce iterations those samples executed.
//
// Design.
//  * One thread per lane of the banked layout: thread l serves positions
//    l + k * n_lanes for k < n_banks (the map of the host-side
//    ops/persistent.py:bank_geometry, which _balanced_perm relies on).
//    Positions past P are masked.  For each position a plain loop runs over
//    samples, then bounces; a thread whose path ends starts the pixel's next
//    sample at once (the TPU kernel's in-lane regeneration, here with no
//    masks and no cross-thread traffic).
//  * Ray state stays in registers.  Each sum is written once, by the thread
//    that owns the position: no atomics, so results are deterministic and a
//    pixel's value does not depend on the lane or the bank count.
//  * Sphere tables are loaded once per block into shared memory as packed
//    float4 (cx, cy, cz, r), float4 (albedo rgb, fuzz), float2 (ior,
//    material).  All threads of a warp read the same sphere at once, so the
//    loads broadcast.  The scan tracks only (t, index); the winner's
//    attributes are read once after it.  r^2 is recomputed from r, so a
//    padding slot with a NaN radius rejects itself for every ray.
//  * The device functions it shares with the gradient kernels (threefry,
//    camera ray, sphere scan, plane test, scatter) live in common.cuh.
//  * RNG: counter-based threefry2x32 with counters
//    (pixel, (sample_id << 8) | slot), bit-identical to the JAX package:
//    camera jitter uses slots 124/125, bounce b uses 4b+0..2 for scatter
//    and 4b+3 for the Russian-roulette word.
//
// Bound.  The work is the sphere scan, FP32 arithmetic with no matrix
// product, so the kernel is bound by the card's FP32 rate, not by bytes
// (it reads 4 B of pixel id and writes 16 B per pixel).  One sphere test
// in closest_hit below is 20 FP32 operations, the sqrt counted as 1
// (compares and selects not counted): 3 subtractions for oc,
// 5 for tc, 5 for |oc|^2, 2 for |oc|^2 - tc^2, 2 for r^2 - (...), 1 sqrt,
// 2 for the two roots.  So
//     bound = sum(iteration counts) * S * 20 / (FP32 peak)
// with S spheres.  What the design does about it: the scan's inner loop is
// the only O(S) work, its operands come from shared-memory broadcasts and
// registers, and dead paths cost nothing (a thread regenerates instead of
// idling), so the count of sphere tests is what the paths need.
//
// Numerics.  Built without --use_fast_math: the NaN self-reject and the
// comparison with the plain PyTorch version rely on IEEE sqrtf, division,
// logf and expf.  Built with --fmad=false: no product is contracted into an
// FMA, so every add, multiply, divide and sqrt rounds as PyTorch's
// elementwise kernels round it in the plain version.  With contraction on,
// |oc|^2 - tc^2 on the r=1000 ground sphere (both terms ~1e6, f32 ulp 0.06)
// rounded differently and flipped grazing self-hits on 1% of cover-scene
// pixels; the cost is one instruction more for each of the 6 FMAs of a
// sphere test.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) persistent_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    float* __restrict__ out_rad, float* __restrict__ out_cnt) {
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;

  // consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32
  // (origin, lower_left, horizontal, vertical, u, v, lens radius).
  float sky[6], pl[7], cam[19];
#pragma unroll
  for (int i = 0; i < 6; ++i) sky[i] = consts[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) pl[i] = consts[6 + i];
#pragma unroll
  for (int i = 0; i < 19; ++i) cam[i] = consts[13 + i];

  for (int k = 0; k < n_banks; ++k) {
    const long long pos = static_cast<long long>(k) * n_lanes + lane;
    if (pos >= n_pix) break;
    const uint32_t pix = static_cast<uint32_t>(pixel_ids[pos]);
    const float xf = static_cast<float>(pix % static_cast<uint32_t>(width));
    const float yf = static_cast<float>(pix / static_cast<uint32_t>(width));
    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, iters = 0.0f;

    for (int s = 0; s < n_samples; ++s) {
      const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
      float ox, oy, oz, dx, dy, dz;
      camera_ray(cam, k0, k1, pix, c1b, xf, yf, inv_w, inv_h, ox, oy, oz, dx,
                 dy, dz);
      float tr = 1.0f, tg = 1.0f, tb = 1.0f;

      for (int b = 0; b < max_depth; ++b) {
        iters += 1.0f;
        float bt = t_max;
        const int bi = closest_hit(tabs.geo, n_spheres, ox, oy, oz, dx, dy,
                                   dz, t_min, bt);
        bool hit = bi >= 0;
        float cx = 0.0f, cy = 0.0f, cz = 0.0f, r = 1.0f;
        float ar = 0.0f, ag = 0.0f, ab = 0.0f, fz = 0.0f, io = 1.0f;
        int mat = kLambertian;
        if (hit) {
          const float4 g = tabs.geo[bi], a = tabs.att[bi];
          const float2 a2 = tabs.att2[bi];
          cx = g.x; cy = g.y; cz = g.z; r = g.w;
          ar = a.x; ag = a.y; ab = a.z; fz = a.w;
          io = a2.x;
          mat = static_cast<int>(a2.y);
        }
        float tp, sgn;
        if (use_plane &&
            plane_wins(pl, ox, oy, oz, dx, dy, dz, t_min, bt, tp, sgn)) {
          // Ground plane merged as a virtual unit sphere tangent at the hit
          // point (plane_override): the normal below comes out face-forward.
          cx = (ox + tp * dx) - sgn * pl[0];
          cy = (oy + tp * dy) - sgn * pl[1];
          cz = (oz + tp * dz) - sgn * pl[2];
          r = 1.0f;
          ar = pl[4]; ag = pl[5]; ab = pl[6];
          fz = 0.0f; io = 1.0f;
          mat = kLambertian;
          bt = tp;
          hit = true;
        }
        if (!hit) {
          // Sky on a live miss, then the path ends.
          const float h = 0.5f * (dy + 1.0f);
          acc_r += tr * (sky[0] + (sky[3] - sky[0]) * h);
          acc_g += tg * (sky[1] + (sky[4] - sky[1]) * h);
          acc_b += tb * (sky[2] + (sky[5] - sky[2]) * h);
          break;
        }
        // Hit point + outward normal (negative radius flips it).
        const float px = ox + bt * dx, py = oy + bt * dy, pz = oz + bt * dz;
        float nx = (px - cx) / r, ny = (py - cy) / r, nz = (pz - cz) / r;
        const float inv = rsqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
        nx *= inv; ny *= inv; nz *= inv;

        const uint32_t slot0 = static_cast<uint32_t>(b) * 4u;
        float u[6];
        uniforms(k0, k1, pix, c1b | slot0, u[0], u[1]);
        uniforms(k0, k1, pix, c1b | (slot0 + 1u), u[2], u[3]);
        uniforms(k0, k1, pix, c1b | (slot0 + 2u), u[4], u[5]);
        float sdx, sdy, sdz;
        bool is_diel;
        const bool scattered = scatter(dx, dy, dz, nx, ny, nz, mat, fz, io,
                                       u, sdx, sdy, sdz, is_diel);
        if (!scattered || b + 1 >= max_depth) break;
        if (!is_diel) {
          tr *= ar; tg *= ag; tb *= ab;
        }
        if (rr_start_depth > 0 && b >= rr_start_depth) {
          // Russian roulette on the throughput after this bounce.
          const float q = fminf(fmaxf(fmaxf(fmaxf(tr, tg), tb), 0.05f), 1.0f);
          float u6, unused;
          uniforms(k0, k1, pix, c1b | (slot0 + 3u), u6, unused);
          if (u6 >= q) break;
          const float boost = 1.0f / q;
          tr *= boost; tg *= boost; tb *= boost;
        }
        ox = px; oy = py; oz = pz;
        dx = sdx; dy = sdy; dz = sdz;
      }
    }
    out_rad[3 * pos + 0] = acc_r;
    out_rad[3 * pos + 1] = acc_g;
    out_rad[3 * pos + 2] = acc_b;
    if (out_cnt != nullptr) out_cnt[pos] = iters;
  }
}

}  // namespace
}  // namespace spt

// Launch on the caller's stream.  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_persistent_render(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, void* out_rad,
    void* out_cnt, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * spt::kSmemPerSphere;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spt::persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_lanes + spt::kThreads - 1) / spt::kThreads;
  spt::persistent_kernel<<<blocks, spt::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      static_cast<float*>(out_rad), static_cast<float*>(out_cnt));
  return static_cast<int>(cudaGetLastError());
}
