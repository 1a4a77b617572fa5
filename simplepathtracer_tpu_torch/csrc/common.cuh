// Device functions shared by the port's kernels (persistent.cu, grad_regen.cu,
// grad.cu, bounce_step.cu, closest_hit.cu): the counterparts of the tile
// functions of the JAX package's ops/pallas_common.py that the forward and
// gradient kernels run (threefry2x32, to_unit_float, the bounce uniforms of
// pallas_grad_regen._uniforms7_tile, camera_ray_tiles, closest_hit_scan and
// its shared-memory sphere tables, plane_override, scatter_tiles, and the
// soft scan closest_hit_scan_soft with silhouette_logit_tile), and the
// host's grid-stride launch helpers.
//
// Numerics: the library is built without --use_fast_math and with
// --fmad=false, so every add, multiply, divide and sqrt rounds as the
// PyTorch elementwise ops of the kernels' plain versions do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spt {

constexpr int kTabCols = 10;  // cx cy cz r ar ag ab fuzz ior material
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kLambertian = 0;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;
// Bytes of shared memory per sphere slot: float4 + float4 + float2.
constexpr int kSmemPerSphere = 2 * sizeof(float4) + sizeof(float2);

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

// The 8 bounce uniforms of bounce b (slots 4b .. 4b+3): 0-1 Lambertian,
// 2-4 metal fuzz ball, 5 dielectric coin, 6 Russian roulette, 7 the
// soft-silhouette acceptance coin.  (The crossing and validity coins of
// soft silhouettes are slot 128 + b.)
__device__ __forceinline__ void bounce_uniforms(uint32_t k0, uint32_t k1,
                                                uint32_t pix, uint32_t c1b,
                                                uint32_t b, float (&u)[8]) {
  const uint32_t slot0 = b * 4u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uniforms(k0, k1, pix, c1b | (slot0 + static_cast<uint32_t>(e)), u[2 * e],
             u[2 * e + 1]);
  }
}

// Thin-lens camera ray for pixel (xf, yf) of sample counter c1b (slots
// 124/125); cam: the f32[19] block of ops/persistent.py:camera_constants.
__device__ __forceinline__ void camera_ray(const float (&cam)[19], uint32_t k0,
                                           uint32_t k1, uint32_t pix,
                                           uint32_t c1b, float xf, float yf,
                                           float inv_w, float inv_h, float& ox,
                                           float& oy, float& oz, float& dx,
                                           float& dy, float& dz) {
  float jx, jy, lu, lv;
  uniforms(k0, k1, pix, c1b | 124u, jx, jy);
  uniforms(k0, k1, pix, c1b | 125u, lu, lv);
  const float s01 = (xf + jx) * inv_w;
  const float t01 = 1.0f - (yf + jy) * inv_h;
  const float lr = sqrtf(lu) * cam[18];
  float sth, cth;
  sincosf(kTwoPi * lv, &sth, &cth);
  const float ou = lr * cth, ov = lr * sth;
  ox = cam[0] + ou * cam[12] + ov * cam[15];
  oy = cam[1] + ou * cam[13] + ov * cam[16];
  oz = cam[2] + ou * cam[14] + ov * cam[17];
  dx = cam[3] + s01 * cam[6] + t01 * cam[9] - ox;
  dy = cam[4] + s01 * cam[7] + t01 * cam[10] - oy;
  dz = cam[5] + s01 * cam[8] + t01 * cam[11] - oz;
  const float ninv = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
  dx *= ninv; dy *= ninv; dz *= ninv;
}

// Shared-memory sphere tables: float4 (cx, cy, cz, r), float4 (albedo rgb,
// fuzz), float2 (ior, material).  All threads of a warp read the same
// sphere at once, so the loads broadcast.
struct SphereTables {
  float4* geo;
  float4* att;
  float2* att2;
};

// Load the [n_spheres, kTabCols] table into dynamic shared memory (the
// caller's block synchronises after).
__device__ __forceinline__ SphereTables load_sphere_tables(
    float4* smem, const float* __restrict__ tab, int n_spheres) {
  SphereTables t;
  t.geo = smem;
  t.att = smem + n_spheres;
  t.att2 = reinterpret_cast<float2*>(smem + 2 * n_spheres);
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    const float* row = tab + static_cast<size_t>(i) * kTabCols;
    t.geo[i] = make_float4(row[0], row[1], row[2], row[3]);
    t.att[i] = make_float4(row[4], row[5], row[6], row[7]);
    t.att2[i] = make_float2(row[8], row[9]);
  }
  return t;
}

// The attributes of sphere slot bi (cx cy cz r, albedo rgb, fuzz, ior) into
// w[9] and its material; on a miss (bi < 0) the scan's defaults: r = 1,
// ior = 1, the rest 0.
__device__ __forceinline__ void sphere_attrs(const SphereTables& t, int bi,
                                             float* w, int& mat) {
  if (bi >= 0) {
    const float4 g = t.geo[bi], a = t.att[bi];
    const float2 a2 = t.att2[bi];
    w[0] = g.x; w[1] = g.y; w[2] = g.z; w[3] = g.w;
    w[4] = a.x; w[5] = a.y; w[6] = a.z; w[7] = a.w;
    w[8] = a2.x;
    mat = static_cast<int>(a2.y);
  } else {
    w[0] = w[1] = w[2] = 0.0f;
    w[3] = 1.0f;
    w[4] = w[5] = w[6] = w[7] = 0.0f;
    w[8] = 1.0f;
    mat = kLambertian;
  }
}

// Closest sphere hit: nearest root in (t_min, bt), first index on ties;
// -1 on a miss.  r^2 is recomputed from r, so a padding slot with a NaN
// radius rejects itself for every ray.  The roots are taken only where
// disc >= 0: elsewhere (a NaN disc too) the sqrt would be NaN and every
// compare after it fail, so skipping them changes no result, and most
// tests are misses (in a warp of rays from nearby pixels, misses of the
// whole warp).
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
    if (disc >= 0.0f) {
      const float sq = sqrtf(disc);
      const float t_near = tc - sq;
      const float t = t_near > t_min ? t_near : tc + sq;
      if (t > t_min && t < bt) {
        bt = t;
        bi = i;
      }
    }
  }
  return bi;
}

// Acceptance-coin logit of the soft scan: clamp(log(max(u, 1e-30)) -
// log(max(1 - u, 1e-30)), -30, 30), as ops/intersect.py:silhouette_logit
// (logf rounds as PyTorch's log on the card).
__device__ __forceinline__ float silhouette_logit(float u) {
  const float lg = logf(fmaxf(u, 1e-30f)) - logf(fmaxf(1.0f - u, 1e-30f));
  return fminf(fmaxf(lg, -30.0f), 30.0f);
}

// Load the soft scan's [n_spheres, 4] table (silhouette scale, 1 / r^2,
// validity scale, -30 x validity scale; ops/grad_regen.py:regen_call)
// into shared memory at ``dst``.
__device__ __forceinline__ float4* load_soft_table(float4* dst,
                                                   const float* __restrict__ st,
                                                   int n_spheres) {
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    const float* row = st + static_cast<size_t>(i) * 4;
    dst[i] = make_float4(row[0], row[1], row[2], row[3]);
  }
  return dst;
}

// The soft (stochastic-transparency) scan: ops/grad_regen.py:_scan_soft's
// spheres, one pass.  Sphere i is accepted iff disc > lgt * scale_i and its
// raw root t_raw beats t_min + lgtv * sigma_v,i (hard t_min for the chain's
// previous winner ``prev``); the winner is the nearest accepted sphere at t
// = max(t_raw, t_min), first on ties (bt, bi; -1 on a miss).  The blocker
// qi is the rejected sphere of largest disc / r^2, first on ties, whose t
// beats the best accepted t before it and whose raw root lies above t_min
// - 30 sigma_v,i (-1 if none).  Padding slots (NaN radius) fail every
// test: disc and the score are NaN.
//
// Skip: the winner update needs disc > lgt * scale_i (acceptance) and the
// blocker update disc / r_i^2 > qs, so a sphere that passes neither changes
// nothing and its root, t and thresholds are not computed (a NaN disc fails
// both, as it fails every test after them).  Where disc <= 1e-12 (a NaN
// disc too) the root sqrt(max(disc, 1e-12)) is the constant sqrt(1e-12).
// The order of the spheres, the first-on-ties rules and qs's update are
// those of the full test.
__device__ __forceinline__ void closest_hit_soft(
    const float4* __restrict__ geo, const float4* __restrict__ soft,
    int n_spheres, float ox, float oy, float oz, float dx, float dy, float dz,
    float t_min, float t_max, float lgt, float lgtv, int prev, float& bt,
    int& bi, int& qi) {
  bt = t_max;
  bi = -1;
  qi = -1;
  float qs = -INFINITY;
  const float sq_min = sqrtf(1e-12f);
#pragma unroll 2
  for (int i = 0; i < n_spheres; ++i) {
    const float4 g = geo[i];
    const float4 st = soft[i];
    const float ocx = g.x - ox, ocy = g.y - oy, ocz = g.z - oz;
    const float tc = ocx * dx + ocy * dy + ocz * dz;
    const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
    const float disc = g.w * g.w - (oc2 - tc * tc);
    const bool in_band = disc > lgt * st.x;
    const float score = disc * st.y;
    if (!in_band && !(score > qs)) continue;
    // sqrt(max(disc, 1e-12)): the clamped root is a constant.
    float sq = sq_min;
    if (disc > 1e-12f) sq = sqrtf(disc);
    const float t_near = tc - sq;
    const float t_raw = t_near > t_min ? t_near : tc + sq;
    const float t = fmaxf(t_raw, t_min);
    const bool is_prev = prev == i;
    const float thr_v = is_prev ? 0.0f : lgtv * st.z;
    const float gate = is_prev ? 0.0f : st.w;
    const bool accept = in_band && t_raw > t_min + thr_v && t_raw < t_max;
    const bool in_front = t < bt;
    if (!accept && t_raw > t_min + gate && in_front && score > qs) {
      qi = i;
      qs = score;
    }
    if (accept && in_front) {
      bt = t;
      bi = i;
    }
  }
}

// Ground-plane test of plane_override: the plane {p : n.p + k = 0} (pl =
// normal xyz, offset, albedo rgb) wins where it is hit nearer than bt.
// Returns whether it wins, with its t and the face-forward sign.
__device__ __forceinline__ bool plane_wins(const float (&pl)[7], float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float t_min,
                                           float bt, float& tp, float& sgn) {
  const float denom = dx * pl[0] + dy * pl[1] + dz * pl[2];
  const float num = -(ox * pl[0] + oy * pl[1] + oz * pl[2] + pl[3]);
  const bool live = fabsf(denom) > 1e-8f;
  tp = num / (live ? denom : 1.0f);
  sgn = denom > 0.0f ? -1.0f : 1.0f;
  return live && tp > t_min && tp < bt;
}

// Branch on the material: each thread computes only its own scatter
// (scatter_tiles computes all three and selects; the chosen branch's ops
// are the same).  Returns false where a metal ray is absorbed into the
// surface.
__device__ __forceinline__ bool scatter(
    float dx, float dy, float dz, float nx, float ny, float nz, int mat,
    float fz, float io, const float* __restrict__ u,
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

// Blocks for a grid-stride launch of ``threads``-thread blocks over n items:
// at most as many as the card keeps resident at once (so each block loads
// its tables once), at least one.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, long long n, size_t smem,
                     int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long long want = (n + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = static_cast<int>(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  return cudaSuccess;
}

// Allow ``smem`` bytes of dynamic shared memory where it is above 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace spt
