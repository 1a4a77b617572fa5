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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTabCols = 10;  // cx cy cz r ar ag ab fuzz ior material
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kLambertian = 0;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry2x32, identical to ops/sampling.py:threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define SPT_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;
  SPT_ROUND(13) SPT_ROUND(15) SPT_ROUND(26) SPT_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  SPT_ROUND(17) SPT_ROUND(29) SPT_ROUND(16) SPT_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  SPT_ROUND(13) SPT_ROUND(15) SPT_ROUND(26) SPT_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  SPT_ROUND(17) SPT_ROUND(29) SPT_ROUND(16) SPT_ROUND(24)
  x0 += k1; x1 += ks2 + 4u;
  SPT_ROUND(13) SPT_ROUND(15) SPT_ROUND(26) SPT_ROUND(6)
  x0 += ks2; x1 += k0 + 5u;
#undef SPT_ROUND
  o0 = x0;
  o1 = x1;
}

// Top 24 bits -> f32 in [0, 1), exact.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * 0x1p-24f;
}

__device__ __forceinline__ void uniforms(uint32_t k0, uint32_t k1,
                                         uint32_t pix, uint32_t c1,
                                         float& a, float& b) {
  uint32_t w0, w1;
  threefry2x32(k0, k1, pix, c1, w0, w1);
  a = unit_float(w0);
  b = unit_float(w1);
}

// Branch on the material: each thread computes only its own scatter
// (the TPU kernel computed all three and selected).  Returns false where a
// metal ray is absorbed into the surface.
__device__ __forceinline__ bool scatter(
    float dx, float dy, float dz, float nx, float ny, float nz, int mat,
    float fz, float io, const float (&u)[6],
    float& sdx, float& sdy, float& sdz, bool& is_diel) {
  const float d_dot_n = dx * nx + dy * ny + dz * nz;
  const bool front = d_dot_n < 0.0f;
  const float fs = front ? 1.0f : -1.0f;
  const float nfx = nx * fs, nfy = ny * fs, nfz = nz * fs;
  is_diel = mat == kDielectric;
  float gx, gy, gz;
  if (mat == kMetal || mat == kDielectric) {
    const float dn = dx * nfx + dy * nfy + dz * nfz;
    const float two_dn = 2.0f * dn;
    const float rfx = dx - two_dn * nfx;
    const float rfy = dy - two_dn * nfy;
    const float rfz = dz - two_dn * nfz;
    if (mat == kMetal) {
      // Mirror + fuzz * uniform point in the unit ball (radius U^(1/3)).
      const float zm = 1.0f - 2.0f * u[2];
      const float rm = sqrtf(fmaxf(1.0f - zm * zm, 0.0f));
      float sm, cm;
      sincosf(kTwoPi * u[3], &sm, &cm);
      const float bscale =
          expf(logf(fmaxf(u[4], 1e-30f)) * (1.0f / 3.0f)) * fz;
      gx = rfx + bscale * rm * cm;
      gy = rfy + bscale * rm * sm;
      gz = rfz + bscale * zm;
    } else {
      // Schlick reflectance; total internal reflection tested sqrt-free.
      const float cos_t = fminf(-dn, 1.0f);
      const float eta = front ? 1.0f / io : io;
      const float sin2 = fmaxf(1.0f - cos_t * cos_t, 0.0f);
      const bool cannot = eta * eta * sin2 > 1.0f;
      const float r0s = (1.0f - eta) / (1.0f + eta);
      const float r0 = r0s * r0s;
      const float omc = 1.0f - cos_t;
      const float omc2 = omc * omc;
      const float refl_p = r0 + (1.0f - r0) * omc2 * omc2 * omc;
      if (cannot || u[5] < refl_p) {
        gx = rfx; gy = rfy; gz = rfz;
      } else {
        const float ppx = eta * (dx + cos_t * nfx);
        const float ppy = eta * (dy + cos_t * nfy);
        const float ppz = eta * (dz + cos_t * nfz);
        const float par =
            sqrtf(fmaxf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz), 1e-12f));
        gx = ppx - par * nfx;
        gy = ppy - par * nfy;
        gz = ppz - par * nfz;
      }
    }
  } else {
    // Lambertian: face normal + uniform point on the unit sphere.
    const float zl = 1.0f - 2.0f * u[0];
    const float rl = sqrtf(fmaxf(1.0f - zl * zl, 0.0f));
    float sl, cl;
    sincosf(kTwoPi * u[1], &sl, &cl);
    gx = nfx + rl * cl;
    gy = nfy + rl * sl;
    gz = nfz + zl;
  }
  const float g2 = gx * gx + gy * gy + gz * gz;
  if (g2 <= 1e-12f) {
    sdx = nfx; sdy = nfy; sdz = nfz;
  } else {
    const float ginv = rsqrtf(fmaxf(g2, 1e-20f));
    sdx = gx * ginv; sdy = gy * ginv; sdz = gz * ginv;
  }
  return mat != kMetal || (sdx * nfx + sdy * nfy + sdz * nfz > 0.0f);
}

// Closest sphere hit: nearest root in (t_min, t_max); -1 on a miss.
__device__ __forceinline__ int closest_hit(const float4* __restrict__ geo,
                                           int n_spheres, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float t_min, float& bt) {
  int bi = -1;
#pragma unroll 4
  for (int i = 0; i < n_spheres; ++i) {
    const float4 g = geo[i];
    const float ocx = g.x - ox, ocy = g.y - oy, ocz = g.z - oz;
    const float tc = ocx * dx + ocy * dy + ocz * dz;
    const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
    const float disc = g.w * g.w - (oc2 - tc * tc);
    const float sq = sqrtf(disc);  // NaN for disc < 0: every compare fails
    const float t_near = tc - sq;
    const float t = t_near > t_min ? t_near : tc + sq;
    if (t > t_min && t < bt) {
      bt = t;
      bi = i;
    }
  }
  return bi;
}

__global__ void __launch_bounds__(kThreads) persistent_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    float* __restrict__ out_rad, float* __restrict__ out_cnt) {
  extern __shared__ float4 smem[];
  float4* geo = smem;                                           // cx cy cz r
  float4* att = smem + n_spheres;                               // rgb fuzz
  float2* att2 = reinterpret_cast<float2*>(smem + 2 * n_spheres);  // ior mat
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    const float* row = tab + static_cast<size_t>(i) * kTabCols;
    geo[i] = make_float4(row[0], row[1], row[2], row[3]);
    att[i] = make_float4(row[4], row[5], row[6], row[7]);
    att2[i] = make_float2(row[8], row[9]);
  }
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
      // Thin-lens camera ray (camera_ray_tiles).
      float jx, jy, lu, lv;
      uniforms(k0, k1, pix, c1b | 124u, jx, jy);
      uniforms(k0, k1, pix, c1b | 125u, lu, lv);
      const float s01 = (xf + jx) * inv_w;
      const float t01 = 1.0f - (yf + jy) * inv_h;
      const float lr = sqrtf(lu) * cam[18];
      float sth, cth;
      sincosf(kTwoPi * lv, &sth, &cth);
      const float ou = lr * cth, ov = lr * sth;
      float ox = cam[0] + ou * cam[12] + ov * cam[15];
      float oy = cam[1] + ou * cam[13] + ov * cam[16];
      float oz = cam[2] + ou * cam[14] + ov * cam[17];
      float dx = cam[3] + s01 * cam[6] + t01 * cam[9] - ox;
      float dy = cam[4] + s01 * cam[7] + t01 * cam[10] - oy;
      float dz = cam[5] + s01 * cam[8] + t01 * cam[11] - oz;
      const float ninv = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
      dx *= ninv; dy *= ninv; dz *= ninv;
      float tr = 1.0f, tg = 1.0f, tb = 1.0f;

      for (int b = 0; b < max_depth; ++b) {
        iters += 1.0f;
        float bt = t_max;
        const int bi = closest_hit(geo, n_spheres, ox, oy, oz, dx, dy, dz,
                                   t_min, bt);
        bool hit = bi >= 0;
        float cx = 0.0f, cy = 0.0f, cz = 0.0f, r = 1.0f;
        float ar = 0.0f, ag = 0.0f, ab = 0.0f, fz = 0.0f, io = 1.0f;
        int mat = kLambertian;
        if (hit) {
          const float4 g = geo[bi], a = att[bi];
          const float2 a2 = att2[bi];
          cx = g.x; cy = g.y; cz = g.z; r = g.w;
          ar = a.x; ag = a.y; ab = a.z; fz = a.w;
          io = a2.x;
          mat = static_cast<int>(a2.y);
        }
        if (use_plane) {
          // Ground plane merged as a virtual unit sphere tangent at the hit
          // point (plane_override): the normal below comes out face-forward.
          const float denom = dx * pl[0] + dy * pl[1] + dz * pl[2];
          const float num = -(ox * pl[0] + oy * pl[1] + oz * pl[2] + pl[3]);
          const bool live = fabsf(denom) > 1e-8f;
          const float tp = num / (live ? denom : 1.0f);
          if (live && tp > t_min && tp < bt) {
            const float sgn = denom > 0.0f ? -1.0f : 1.0f;
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

// Launch on the caller's stream.  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_persistent_render(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, void* out_rad,
    void* out_cnt, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) *
                      (2 * sizeof(float4) + sizeof(float2));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  persistent_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      static_cast<float*>(out_rad), static_cast<float*>(out_cnt));
  return static_cast<int>(cudaGetLastError());
}
