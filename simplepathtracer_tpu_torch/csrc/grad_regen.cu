// Regeneration gradient kernels for Hopper (sm_90a): the recording forward
// (two modes), the scan-free re-forward and the backward, hard and with
// two-sided soft silhouettes.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad_regen.py:
//   regen_kernel<kModeFull, V>   _regen_fwd_kernel, emit_full=True
//   regen_kernel<kModeIdx, V>    _regen_fwd_kernel, emit_idx_only=True
//   regen_kernel<kModeRefwd, V>  _regen_refwd_kernel
//   regen_bwd_kernel<V>          _regen_bwd_kernel
// V = kHard, kSoft (soft silhouettes) or kSoftPlane (soft with a ground
// plane: the crossing coin), so the hard instantiations compile as before.
// Together with ops/pallas_grad.py:bounce_tile (the physics all four share)
// and its jax.vjp, which CUDA does not have: the adjoint is written by hand
// in bounce.cuh (shared with grad.cu) and mirrors the plain PyTorch
// ops/bounce.py:bounce_tile_adjoint line by line.
//
// What they compute.  Lane l of the banked layout (ops/persistent.py:
// bank_geometry) serves the pixels at positions l + k * n_lanes, k <
// n_banks, each for n_samples samples; a lane whose path ends starts the
// next sample (or the next bank's pixel) in the next iteration.  Iteration
// `it` of a lane is one bounce.  The forward records, per iteration, the
// 25 residual planes of the JAX package (entry o, d, tp; alive, regen;
// bank kb, sample s, bounce b; winner idx, material and its 9 attributes;
// soft: the blocker's index and cx cy cz r) or, in idx mode, only the
// winner index packed three to a word (10 bits of idx + 1 each; soft: a
// second plane of blocker indices).  The re-forward replays the same state
// evolution with the sphere scan replaced by the recorded indices, and so
// emits the planes the full forward would have.  The backward walks a
// lane's iterations in reverse with the carried (o, d, tp) cotangents,
// writes the 9 winner attribute cotangents per iteration (soft: and the
// blocker's 4; bucketed into the table by csrc/bucket.cu) and sums the
// lane's sky (6) and plane (4) cotangents.
//
// Soft silhouettes.  The scan (common.cuh:closest_hit_soft) reads its
// per-sphere thresholds from the table the host computed once
// (ops/grad_regen.py:regen_call), and the plane crossing coin records its
// outcome in the winner code: kPlaneCrossIdx marks a plane win whose
// blocker slot holds the crossing loser.  So the backward knows each
// blocker's role without replaying a coin (the JAX kernels replay them
// with thresholds they recompute, which can disagree with the forward's).
// The detached ratio den / stop_grad(den) is 1 in value, so the forward
// kernels compute only what changes values (the capped-sqrt root and its
// clamp to t_min); the backward computes den and its adjoint.
//
// Design.  One thread per lane; ray state in registers.  Planes are
// [n_iter, n_lanes] (iteration-major), so a warp's stores coalesce.  A
// lane's live iterations are 0 .. count - 1 (it regenerates at once until
// its banks are done), so the forward breaks out of its loop there and
// marks the rest dead (alive 0, idx and bidx -1, packed words 0); the
// backward skips dead iterations and writes their cotangents as 0.  Sphere
// tables sit in shared memory (common.cuh); the re-forward reads its
// winner and blocker by index there instead of the TPU's one-hot matrix
// product.  Per-lane partials are written once and summed by the host, so
// every result is deterministic.
//
// Bound.  The recording forward is bound by the sphere scan's FP32 work,
// as the persistent kernel (20 operations per sphere test; the soft scan
// ~30); the re-forward and backward do O(1) work per iteration and are
// bound by the planes they write and read (25 planes out; 25 in and 9 out;
// soft: 30 out; 30 in and 13 out).
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt / division: every
// operation rounds as the PyTorch elementwise op of the plain versions
// (ops/grad_regen.py, ops/bounce.py), so the kernels match them bit for
// bit.  Where the plain version divides a constant by a tensor, PyTorch
// computes reciprocal(x) * c; the code below does the same.  logf and expf
// are the CUDA math library's, as PyTorch's log and exp on the card.

#include "bounce.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
constexpr int kModeFull = 0;
constexpr int kModeIdx = 1;
constexpr int kModeRefwd = 2;
// f32 residual planes: 0-2 o, 3-5 d, 6-8 tp, 9 alive, 10 regen, 11-19 the
// winner's cx cy cz r ar ag ab fuzz ior; soft: 20-23 the blocker's cx cy cz
// r.  i32: 0 kb, 1 s, 2 b, 3 idx, 4 mat; soft: 5 the blocker's index.
constexpr int kFAlive = 9;
constexpr int kFRegen = 10;
constexpr int kFAttr = 11;
constexpr int kFBlk = 20;
constexpr int kIKb = 0, kIS = 1, kIB = 2, kIIdx = 3, kIMat = 4, kIBlk = 5;

struct Consts {
  float sky[6], pl[7], cam[19];
  SoftK soft;
};

// consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32,
// soft constants 32:35 (SoftK; zeros when hard).
__device__ __forceinline__ void load_consts(const float* __restrict__ src,
                                            Consts& k) {
#pragma unroll
  for (int i = 0; i < 6; ++i) k.sky[i] = src[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) k.pl[i] = src[6 + i];
#pragma unroll
  for (int i = 0; i < 19; ++i) k.cam[i] = src[13 + i];
  k.soft.soft = src[32];
  k.soft.sil_c = src[33];
  k.soft.sigv = src[34];
}

__device__ __forceinline__ uint32_t lane_pixel(const int* __restrict__ ids,
                                               int n_pix, int n_lanes, int kb,
                                               int lane) {
  long long pos = static_cast<long long>(kb) * n_lanes + lane;
  if (pos > n_pix - 1) pos = n_pix - 1;  // overflow positions repeat the last
  return static_cast<uint32_t>(ids[pos]);
}

template <int MODE, int V>
__global__ void __launch_bounds__(kThreads) regen_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    int n_iter, const float* __restrict__ soft_tab,
    const int* __restrict__ idx_in, float* __restrict__ out_rad,
    float* __restrict__ out_cnt, float* __restrict__ resf,
    int* __restrict__ resi, int* __restrict__ packed) {
  constexpr bool kSoftV = V != kHard;
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  const float4* soft = nullptr;
  if constexpr (kSoftV) {
    // After geo, att (n float4 each) and att2 (n float2; n is a multiple
    // of 4).
    soft = load_soft_table(smem + 2 * n_spheres + n_spheres / 2, soft_tab,
                           n_spheres);
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  // Packed words: winners, then (soft) blockers, [n_iter / 3, n_lanes] each.
  const size_t word_stride = static_cast<size_t>(n_iter / 3) * L;
  auto fp = [&](int plane, int it) -> float& {
    return resf[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ip = [&](int plane, int it) -> int& {
    return resi[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = rr_start_depth != 0;

  int kb = 0, s = 0, b = 0;
  bool alive = false;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  float tp[3] = {1.0f, 1.0f, 1.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  uint32_t pix = 0;
  int word = 0, bword = 0;
  int prev = -1;  // soft: the chain's previous sphere winner
  int it = 0;
  for (; it < n_iter; ++it) {
    const bool regen = !alive && kb < n_banks;
    if (!alive && !regen) break;  // every bank done: the rest is dead
    const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
    if (regen) {
      // Next sample (or the next bank's pixel): a fresh camera ray.
      pix = lane_pixel(pixel_ids, n_pix, n_lanes, kb, lane);
      const float xf = static_cast<float>(pix % static_cast<uint32_t>(width));
      const float yf = static_cast<float>(pix / static_cast<uint32_t>(width));
      camera_ray(k.cam, k0, k1, pix, c1b, xf, yf, inv_w, inv_h, o[0], o[1],
                 o[2], d[0], d[1], d[2]);
      tp[0] = tp[1] = tp[2] = 1.0f;
      b = 0;
      prev = -1;
      alive = true;
    }
    if (MODE != kModeIdx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        fp(c, it) = o[c];
        fp(3 + c, it) = d[c];
        fp(6 + c, it) = tp[c];
      }
      fp(kFAlive, it) = 1.0f;
      fp(kFRegen, it) = regen ? 1.0f : 0.0f;
      ip(kIKb, it) = kb;
      ip(kIS, it) = s;
      ip(kIB, it) = b;
    }
    Bounce f;
    // Soft: the acceptance coin u[7] is read by the scan.
    if constexpr (kSoftV) bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    const int field = it % 3;
    int bi, qi = -1;
    if (MODE == kModeRefwd) {
      // The recorded winner (and blocker) instead of the scan.
      const size_t w = static_cast<size_t>(it / 3) * L + lane;
      if (field == 0) {
        word = idx_in[w];
        if constexpr (kSoftV) bword = idx_in[word_stride + w];
      }
      bi = ((word >> (kIdxBits * field)) & kIdxMask) - 1;
      if constexpr (kSoftV) qi = ((bword >> (kIdxBits * field)) & kIdxMask) - 1;
    } else if constexpr (kSoftV) {
      // Acceptance coin u[7]; crossing (ux) and validity (uv) coins in
      // slot 128 + b.
      float ux, uv;
      uniforms(k0, k1, pix, c1b | (128u + static_cast<uint32_t>(b)), ux, uv);
      float bt;
      closest_hit_soft(tabs.geo, soft, n_spheres, o[0], o[1], o[2], d[0],
                       d[1], d[2], t_min, t_max, silhouette_logit(f.u[7]),
                       silhouette_logit(uv), prev, bt, bi, qi);
      if constexpr (V == kSoftPlane) {
        // Plane-vs-sphere crossing coin: the sphere beats the plane iff
        // t_s < t_p + logit(ux) * sigma_x(r_s); a plane win over a sphere
        // less than 30 sigma_x behind stashes that sphere as the blocker.
        const float denom = d[0] * k.pl[0] + d[1] * k.pl[1] + d[2] * k.pl[2];
        const float num = -(o[0] * k.pl[0] + o[1] * k.pl[1] + o[2] * k.pl[2] + k.pl[3]);
        const bool live = fabsf(denom) > 1e-8f;
        const float tpl = num / (live ? denom : 1.0f);
        const float pre_r = bi >= 0 ? tabs.geo[bi].w : 1.0f;
        const float sigx = crossing_scale(pre_r, k.soft);
        const float thr_x = silhouette_logit(ux) * sigx;
        const bool wins = live && tpl > t_min && tpl < t_max &&
                          !(bi >= 0 && bt < tpl + thr_x);
        const bool steal = wins && bi >= 0 && bt - tpl < 30.0f * sigx;
        if (steal) qi = bi;
        if (wins) bi = steal ? kPlaneCrossIdx : kPlaneIdx;
      }
    } else {
      float bt = t_max;
      bi = closest_hit(tabs.geo, n_spheres, o[0], o[1], o[2], d[0], d[1],
                       d[2], t_min, bt);
      float tpl, sgn;
      if (use_plane && plane_wins(k.pl, o[0], o[1], o[2], d[0], d[1], d[2],
                                  t_min, bt, tpl, sgn))
        bi = kPlaneIdx;
    }
    float w[9];
    winner_attrs(tabs, k.pl, bi, w, f.mat);
    float blk[4];
    if constexpr (kSoftV) blocker_attrs(tabs, qi, blk);
    if (MODE == kModeIdx) {
      const int v = bi + 1;
      word = field == 0 ? v : word + v * (1 << (kIdxBits * field));
      if constexpr (kSoftV) {
        const int bv = qi + 1;
        bword = field == 0 ? bv : bword + bv * (1 << (kIdxBits * field));
      }
      if (field == 2) {
        const size_t wpos = static_cast<size_t>(it / 3) * L + lane;
        packed[wpos] = word;
        if constexpr (kSoftV) packed[word_stride + wpos] = bword;
      }
    } else {
      ip(kIIdx, it) = bi;
      ip(kIMat, it) = f.mat;
#pragma unroll
      for (int j = 0; j < 9; ++j) fp(kFAttr + j, it) = w[j];
      if constexpr (kSoftV) {
        ip(kIBlk, it) = qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) fp(kFBlk + j, it) = blk[j];
      }
    }

    // The bounce (soft: its values; the detached ratio is 1).
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = o[c];
      f.d[c] = d[c];
      f.tp[c] = tp[c];
      f.c[c] = w[c];
      f.alb[c] = w[4 + c];
    }
    f.r = w[3];
    f.fz = w[7];
    f.io = w[8];
    f.hit = bi >= 0;
    if constexpr (kSoftV) {
      f.pm = V == kSoftPlane && is_plane_code(bi);
    } else {
      f.pm = use_plane && bi == kPlaneIdx;
    }
    f.do_rr = b >= rr_start_depth;
    if constexpr (!kSoftV) bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
    const bool surv = f.surv && b + 1 < max_depth;
    if (!f.hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + f.rad[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = f.no[c];
      d[c] = f.nd[c];
      tp[c] = f.ntp[c];
    }
    if constexpr (kSoftV) prev = f.hit && !f.pm ? bi : -1;
    if (surv) {
      ++b;
    } else if (++s >= n_samples) {
      // The bank's last sample ended: its pixel's sum is complete.
      const long long pos = static_cast<long long>(kb) * n_lanes + lane;
      if (MODE != kModeRefwd && pos < n_pix) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out_rad[3 * pos + c] = acc[c];
      }
      acc[0] = acc[1] = acc[2] = 0.0f;
      s = 0;
      ++kb;
    }
    alive = surv;
  }
  if (MODE != kModeRefwd) out_cnt[lane] = static_cast<float>(it);
  // Iterations after the lane's end read as dead.
  for (; it < n_iter; ++it) {
    if (MODE == kModeIdx) {
      const int field = it % 3;
      if (field == 0) {
        word = 0;
        if constexpr (kSoftV) bword = 0;
      }
      if (field == 2) {
        const size_t wpos = static_cast<size_t>(it / 3) * L + lane;
        packed[wpos] = word;
        if constexpr (kSoftV) packed[word_stride + wpos] = bword;
      }
    } else {
      fp(kFAlive, it) = 0.0f;
      ip(kIIdx, it) = -1;
      if constexpr (kSoftV) ip(kIBlk, it) = -1;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) regen_bwd_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, const float* __restrict__ resf,
    const int* __restrict__ resi, const float* __restrict__ ct_rad,
    float* __restrict__ ct_planes, float* __restrict__ partials) {
  constexpr bool kSoftV = V != kHard;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  auto fp = [&](int plane, int it) -> float {
    return resf[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ip = [&](int plane, int it) -> int {
    return resi[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ct = [&](int j, int it) -> float& {
    return ct_planes[j * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = rr_start_depth != 0;
  const bool plane_on = V == kSoftPlane || (V == kHard && use_plane);
  constexpr int kCt = kSoftV ? 13 : 9;

  float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f};
  float ctp[3] = {0.0f, 0.0f, 0.0f};
  float sky_part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float pl_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = n_iter - 1; it >= 0; --it) {
    if (!(fp(kFAlive, it) > 0.0f)) {
      // Dead iteration: the carried cotangents pass through.
#pragma unroll
      for (int j = 0; j < kCt; ++j) ct(j, it) = 0.0f;
      continue;
    }
    Bounce f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = fp(c, it);
      f.d[c] = fp(3 + c, it);
      f.tp[c] = fp(6 + c, it);
      f.c[c] = fp(kFAttr + c, it);
      f.alb[c] = fp(kFAttr + 4 + c, it);
    }
    f.r = fp(kFAttr + 3, it);
    f.fz = fp(kFAttr + 7, it);
    f.io = fp(kFAttr + 8, it);
    const int kb = ip(kIKb, it), s = ip(kIS, it), b = ip(kIB, it);
    const int idx = ip(kIIdx, it);
    f.mat = ip(kIMat, it);
    f.hit = idx >= 0;
    f.pm = plane_on && is_plane_code(idx);
    f.do_rr = b >= rr_start_depth;
    // The lane's bank: its pixel (for the uniforms) and radiance cotangent.
    const uint32_t pix = lane_pixel(pixel_ids, n_pix, n_lanes, kb, lane);
    const long long pos = static_cast<long long>(kb) * n_lanes + lane;
    float ctr[3] = {0.0f, 0.0f, 0.0f};
    if (pos < n_pix) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ctr[c] = ct_rad[3 * pos + c];
    }
    const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
    bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
    Soft sf;
    SoftCt sa;
    if constexpr (kSoftV) {
      // The blocker and its role (recorded by the forward).
      sf.bval = ip(kIBlk, it) >= 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) sf.bc[c] = fp(kFBlk + c, it);
      sf.br = fp(kFBlk + 3, it);
      soft_forward<V>(f, sf, k.soft, idx == kPlaneCrossIdx, k.pl, t_min,
                      t_max);
    }
    float g_o[3], g_d[3], g_tp[3], g_a9[9], g_sky[6];
    bounce_adjoint<V>(f, rr_on, co, cd, ctp, ctr, g_o, g_d, g_tp, g_a9,
                      g_sky, sf, k.soft, k.pl, t_min, sa);
#pragma unroll
    for (int j = 0; j < 9; ++j) ct(j, it) = f.hit ? g_a9[j] : 0.0f;
    if constexpr (kSoftV) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ct(9 + j, it) = sf.bval ? sa.blk4[j] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) sky_part[c] = sky_part[c] + g_sky[c];
    // The offset also moves the crossing coin's probability on sphere-win
    // lanes.
    if constexpr (V == kSoftPlane) pl_part[0] = pl_part[0] + sa.pk;
    if (f.pm) {
      // Plane offset = the r slot; albedo 1:1; the normal slots dropped.
#pragma unroll
      for (int j = 0; j < 4; ++j) pl_part[j] = pl_part[j] + g_a9[3 + j];
    }
    // A chain's camera ray starts here: the prior chain's final state has
    // no consumers, so the carried cotangents restart from zero.
    const bool regen = fp(kFRegen, it) > 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      co[c] = regen ? 0.0f : g_o[c];
      cd[c] = regen ? 0.0f : g_d[c];
      ctp[c] = regen ? 0.0f : g_tp[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) partials[c * L + lane] = sky_part[c];
#pragma unroll
  for (int j = 0; j < 4; ++j) partials[(6 + j) * L + lane] = pl_part[j];
}

template <int MODE, int V>
cudaError_t launch_regen(const void* pixel_ids, int n_pix, int n_lanes,
                         int n_banks, const void* tab, int n_spheres,
                         const void* consts, int use_plane, uint32_t k0,
                         uint32_t k1, uint32_t sample_offset, int n_samples,
                         int max_depth, int width, float inv_w, float inv_h,
                         float t_min, float t_max, int rr_start_depth,
                         int n_iter, const void* soft_tab, const void* idx_in,
                         void* out_rad, void* out_cnt, void* resf, void* resi,
                         void* packed, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_spheres) *
                      (kSmemPerSphere + (V != kHard ? sizeof(float4) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        regen_kernel<MODE, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  regen_kernel<MODE, V><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      n_iter, static_cast<const float*>(soft_tab),
      static_cast<const int*>(idx_in), static_cast<float*>(out_rad),
      static_cast<float*>(out_cnt), static_cast<float*>(resf),
      static_cast<int*>(resi), static_cast<int*>(packed));
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_regen_variant(int variant, const void* pixel_ids,
                                 int n_pix, int n_lanes, int n_banks,
                                 const void* tab, int n_spheres,
                                 const void* consts, int use_plane,
                                 uint32_t k0, uint32_t k1,
                                 uint32_t sample_offset, int n_samples,
                                 int max_depth, int width, float inv_w,
                                 float inv_h, float t_min, float t_max,
                                 int rr_start_depth, int n_iter,
                                 const void* soft_tab, const void* idx_in,
                                 void* out_rad, void* out_cnt, void* resf,
                                 void* resi, void* packed,
                                 cudaStream_t stream) {
#define SPT_ARGS                                                           \
  pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts, use_plane, k0, \
      k1, sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min,   \
      t_max, rr_start_depth, n_iter, soft_tab, idx_in, out_rad, out_cnt,     \
      resf, resi, packed, stream
  switch (variant) {
    case kHard: return launch_regen<MODE, kHard>(SPT_ARGS);
    case kSoft: return launch_regen<MODE, kSoft>(SPT_ARGS);
    case kSoftPlane: return launch_regen<MODE, kSoftPlane>(SPT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SPT_ARGS
}

// The kernel variant: hard, soft, or soft with a ground plane.
int variant_of(float softness, int use_plane) {
  if (!(softness > 0.0f)) return kHard;
  return use_plane ? kSoftPlane : kSoft;
}

}  // namespace
}  // namespace spt

// Recording forward (mode 0: the residual planes, 1: packed indices) or
// re-forward from packed indices (mode 2), on the caller's stream.
// softness > 0 selects the soft-silhouette variant (soft_tab: the scan's
// [n_spheres, 4] table).  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_regen_forward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, int n_iter, int mode,
    float softness, const void* soft_tab, const void* idx_in, void* out_rad,
    void* out_cnt, void* resf, void* resi, void* packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = spt::variant_of(softness, use_plane);
#define SPT_ARGS                                                           \
  variant, pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts,     \
      use_plane, k0, k1, sample_offset, n_samples, max_depth, width, inv_w, \
      inv_h, t_min, t_max, rr_start_depth, n_iter, soft_tab, idx_in,        \
      out_rad, out_cnt, resf, resi, packed, st
  cudaError_t err;
  switch (mode) {
    case spt::kModeFull: err = spt::launch_regen_variant<spt::kModeFull>(SPT_ARGS); break;
    case spt::kModeIdx: err = spt::launch_regen_variant<spt::kModeIdx>(SPT_ARGS); break;
    case spt::kModeRefwd: err = spt::launch_regen_variant<spt::kModeRefwd>(SPT_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPT_ARGS
  return static_cast<int>(err);
}

// Backward over one chunk's residual planes, on the caller's stream.
extern "C" int spt_regen_backward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, float softness, const void* resf, const void* resi,
    const void* ct_rad, void* ct_planes, void* partials, void* stream) {
  const int blocks = (n_lanes + spt::kThreads - 1) / spt::kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPT_ARGS                                                             \
  static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,               \
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,   \
      n_iter, t_min, t_max, rr_start_depth, static_cast<const float*>(resf), \
      static_cast<const int*>(resi), static_cast<const float*>(ct_rad),      \
      static_cast<float*>(ct_planes), static_cast<float*>(partials)
  switch (spt::variant_of(softness, use_plane)) {
    case spt::kHard:
      spt::regen_bwd_kernel<spt::kHard><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
    case spt::kSoft:
      spt::regen_bwd_kernel<spt::kSoft><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
    default:
      spt::regen_bwd_kernel<spt::kSoftPlane><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
  }
#undef SPT_ARGS
  return static_cast<int>(cudaGetLastError());
}
