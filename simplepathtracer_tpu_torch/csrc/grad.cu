// Per-bounce fused gradient kernels for Hopper (sm_90a): one differentiable
// bounce over explicit rays, its adjoint, and in-kernel camera rays.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad.py:
//   grad_fwd_kernel<V>   _grad_fwd_kernel   (one bounce, emits residuals)
//   grad_bwd_kernel<V>   _grad_bwd_kernel   (one bounce's adjoint)
//   raygen_kernel        _raygen_kernel     (thin-lens rays, slots 124/125)
// V = kHard or kSoft (two-sided soft silhouettes).  Like the JAX kernels
// they are sphere-only: plane scenes take the eager bounce
// (render.trace_rays).  The bounce and its hand-written adjoint are
// bounce.cuh's, shared with the regeneration kernels (grad_regen.cu).
//
// What they compute.  Ray i of a batch of n carries SoA state planes
// [10, n] (origin, direction, throughput, alive) and its radiance [3, n];
// ops/grad.py launches the forward max_depth times, bounce b reading the
// state bounce b - 1 wrote.  The forward runs the scan
// (common.cuh:closest_hit, or closest_hit_soft with the chain's previous
// winner), then bounce_forward, and writes the next state, adds the sky
// radiance of a live miss to the radiance in place, and records the
// residuals the backward needs beside the entry state it read: the winner
// index (-1 on a dead or missed ray) and, soft, the blocker index and the
// previous-winner plane the next bounce's scan reads.  The backward walks
// the bounces in reverse: per ray it rebuilds the bounce from the entry
// state and the recorded indices, runs bounce_adjoint from the carried
// (o, d, tp) cotangents and the radiance cotangent, writes the carried
// cotangents of the entry state, the 9 winner attribute cotangents (soft:
// and the blocker's cx cy cz r; bucketed by csrc/bucket.cu) and sums the
// sky's 6 cotangents over the whole batch.  After bounce 0 the carried
// (o, d) cotangents are the rays' own: autograd chains them into the
// camera (camera.generate_rays).
//
// Design.  One thread per ray, in a grid-stride loop over as many blocks
// as the card keeps resident, so each block loads the sphere table into
// shared memory once.  A dead ray (alive 0) exits at once: the forward
// copies its entry state and writes the JAX kernels' skip values (idx and
// bidx -1), the backward passes its carried cotangents through and writes
// zero attribute cotangents.  The JAX forward also stores the winner's 9
// attributes and material per ray; the backward here instead reads them by
// index from the shared-memory table (the one-hot gather the TPU avoided
// is one indexed load on the GPU), which saves 40 B per ray and bounce of
// device memory: 44 B of residuals per ray-bounce kept (soft 48) against
// the JAX kernels' 84 (104).  The backward reduces the sky cotangents in
// the block (warp shuffles, then shared memory) and adds them with one
// atomic per block and channel, so their last bits change from run to
// run.
//
// Bound.  The forward is bound by the sphere scan's FP32 work (20
// operations per sphere test, the soft scan ~32) on live rays; the
// backward and raygen do O(1) work per ray and are bound by the planes
// they read and write.
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt and division, as
// the other kernels: the forward, the backward's per-ray cotangents and
// raygen match their plain versions (ops/grad.py) bit for bit.

#include "bounce.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
constexpr int kVariants = 2;  // kHard, kSoft
// State planes [10, n]: 0-2 origin, 3-5 direction, 6-8 throughput, 9 alive.
constexpr int kAlive = 9;
// Carried cotangent planes: origin, direction, throughput.
constexpr int kCarry = 9;

// consts: sky lo/hi 0:6, soft constants 6:9 (SoftK; zeros when hard).
struct FusedConsts {
  float sky[6];
  SoftK soft;
};

__device__ __forceinline__ void load_fused_consts(const float* __restrict__ src,
                                                  FusedConsts& k) {
#pragma unroll
  for (int i = 0; i < 6; ++i) k.sky[i] = src[i];
  k.soft.soft = src[6];
  k.soft.sil_c = src[7];
  k.soft.sigv = src[8];
}

// The winner's attributes, for a sphere index or a miss (no plane codes on
// this route: winner_attrs reads its plane block only for those).
__device__ __forceinline__ void load_winner(const SphereTables& t, int bi,
                                            Bounce& f) {
  const float no_plane[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float w[9];
  winner_attrs(t, no_plane, bi, w, f.mat);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.c[c] = w[c];
    f.alb[c] = w[4 + c];
  }
  f.r = w[3];
  f.fz = w[7];
  f.io = w[8];
  f.hit = bi >= 0;
  f.pm = false;
}

template <int V>
__global__ void __launch_bounds__(kThreads) grad_fwd_kernel(
    int n, const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, const float* __restrict__ soft_tab,
    uint32_t k0, uint32_t k1, uint32_t bounce, float t_min, float t_max,
    int rr_start_depth, const float* __restrict__ state,
    const int* __restrict__ pix, const int* __restrict__ samp,
    const int* __restrict__ prev_in, float* __restrict__ next,
    float* __restrict__ rad, int* __restrict__ prev_out,
    int* __restrict__ idx_out, int* __restrict__ bidx_out) {
  constexpr bool kSoftV = V != kHard;
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  const float4* soft = nullptr;
  if constexpr (kSoftV) {
    soft = load_soft_table(smem + 2 * n_spheres + n_spheres / 2, soft_tab,
                           n_spheres);
  }
  __syncthreads();
  FusedConsts k;
  load_fused_consts(consts, k);
  const size_t N = static_cast<size_t>(n);
  const bool rr_on = rr_start_depth != 0;
  const bool do_rr = static_cast<int>(bounce) >= rr_start_depth;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!(state[kAlive * N + i] > 0.0f)) {
      // Dead ray: the bounce is the identity; the skip values.
#pragma unroll
      for (int c = 0; c < kAlive; ++c) next[c * N + i] = state[c * N + i];
      next[kAlive * N + i] = 0.0f;
      idx_out[i] = -1;
      if constexpr (kSoftV) {
        bidx_out[i] = -1;
        prev_out[i] = -1;
      }
      continue;
    }
    Bounce f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = state[c * N + i];
      f.d[c] = state[(3 + c) * N + i];
      f.tp[c] = state[(6 + c) * N + i];
    }
    const uint32_t p = static_cast<uint32_t>(pix[i]);
    const uint32_t c1b = static_cast<uint32_t>(samp[i]) << 8;
    bounce_uniforms(k0, k1, p, c1b, bounce, f.u);
    int bi, qi = -1;
    if constexpr (kSoftV) {
      // Acceptance coin u[7]; validity coin uv in slot 128 + b.
      float ux, uv;
      uniforms(k0, k1, p, c1b | (128u + bounce), ux, uv);
      float bt;
      closest_hit_soft(tabs.geo, soft, n_spheres, f.o[0], f.o[1], f.o[2],
                       f.d[0], f.d[1], f.d[2], t_min, t_max,
                       silhouette_logit(f.u[7]), silhouette_logit(uv),
                       prev_in[i], bt, bi, qi);
    } else {
      float bt = t_max;
      bi = closest_hit(tabs.geo, n_spheres, f.o[0], f.o[1], f.o[2], f.d[0],
                       f.d[1], f.d[2], t_min, bt);
    }
    load_winner(tabs, bi, f);
    f.do_rr = do_rr;
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      next[c * N + i] = f.no[c];
      next[(3 + c) * N + i] = f.nd[c];
      next[(6 + c) * N + i] = f.ntp[c];
    }
    next[kAlive * N + i] = f.surv ? 1.0f : 0.0f;
    if (!f.hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) rad[c * N + i] = rad[c * N + i] + f.rad[c];
    }
    idx_out[i] = f.hit ? bi : -1;
    if constexpr (kSoftV) {
      bidx_out[i] = qi;
      prev_out[i] = f.hit ? bi : -1;
    }
  }
}

// Sum v over the block into out with one atomic: warp shuffles, then the
// warps' sums through shared memory.
template <int K>
__device__ __forceinline__ void block_sum_atomic(float (&v)[K], float* out) {
  __shared__ float part[kThreads / 32][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float x = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += part[w][threadIdx.x];
    atomicAdd(out + threadIdx.x, s);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) grad_bwd_kernel(
    int n, const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, uint32_t k0, uint32_t k1,
    uint32_t bounce, float t_min, float t_max, int rr_start_depth,
    const float* __restrict__ state, const int* __restrict__ idx,
    const int* __restrict__ bidx, const int* __restrict__ pix,
    const int* __restrict__ samp, const float* __restrict__ ct_in,
    const float* __restrict__ ct_rad, float* __restrict__ ct_out,
    float* __restrict__ ct_attr, float* __restrict__ sky_out) {
  constexpr bool kSoftV = V != kHard;
  constexpr int kCt = kSoftV ? 13 : 9;
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();
  FusedConsts k;
  load_fused_consts(consts, k);
  const size_t N = static_cast<size_t>(n);
  const bool rr_on = rr_start_depth != 0;
  const bool do_rr = static_cast<int>(bounce) >= rr_start_depth;
  const float no_plane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sky_acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!(state[kAlive * N + i] > 0.0f)) {
      // Dead ray: the bounce was the identity on (o, d, tp).
#pragma unroll
      for (int c = 0; c < kCarry; ++c) ct_out[c * N + i] = ct_in[c * N + i];
      if (ct_attr != nullptr) {
#pragma unroll
        for (int j = 0; j < kCt; ++j) ct_attr[j * N + i] = 0.0f;
      }
      continue;
    }
    Bounce f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = state[c * N + i];
      f.d[c] = state[(3 + c) * N + i];
      f.tp[c] = state[(6 + c) * N + i];
    }
    load_winner(tabs, idx[i], f);
    f.do_rr = do_rr;
    const uint32_t c1b = static_cast<uint32_t>(samp[i]) << 8;
    bounce_uniforms(k0, k1, static_cast<uint32_t>(pix[i]), c1b, bounce, f.u);
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
    Soft sf;
    SoftCt sa;
    if constexpr (kSoftV) {
      const int qi = bidx[i];
      float blk[4];
      blocker_attrs(tabs, qi, blk);
      sf.bval = qi >= 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) sf.bc[c] = blk[c];
      sf.br = blk[3];
      soft_forward<V>(f, sf, k.soft, false, no_plane, t_min, t_max);
    }
    float co[3], cd[3], ctp[3], ctr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      co[c] = ct_in[c * N + i];
      cd[c] = ct_in[(3 + c) * N + i];
      ctp[c] = ct_in[(6 + c) * N + i];
      ctr[c] = ct_rad[c * N + i];
    }
    float g_o[3], g_d[3], g_tp[3], g_a9[9], g_sky[6];
    bounce_adjoint<V>(f, rr_on, co, cd, ctp, ctr, g_o, g_d, g_tp, g_a9, g_sky,
                      sf, k.soft, no_plane, t_min, sa);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ct_out[c * N + i] = g_o[c];
      ct_out[(3 + c) * N + i] = g_d[c];
      ct_out[(6 + c) * N + i] = g_tp[c];
    }
    if (ct_attr != nullptr) {
#pragma unroll
      for (int j = 0; j < 9; ++j) ct_attr[j * N + i] = f.hit ? g_a9[j] : 0.0f;
      if constexpr (kSoftV) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ct_attr[(9 + j) * N + i] = sf.bval ? sa.blk4[j] : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) sky_acc[c] = sky_acc[c] + g_sky[c];
  }
  block_sum_atomic<6>(sky_acc, sky_out);
}

__global__ void __launch_bounds__(kThreads) raygen_kernel(
    int n, const float* __restrict__ cam19, uint32_t k0, uint32_t k1,
    const int* __restrict__ pix, const int* __restrict__ samp, int width,
    float inv_w, float inv_h, float* __restrict__ rays) {
  float cam[19];
#pragma unroll
  for (int j = 0; j < 19; ++j) cam[j] = cam19[j];
  const size_t N = static_cast<size_t>(n);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t p = static_cast<uint32_t>(pix[i]);
    const float xf = static_cast<float>(p % static_cast<uint32_t>(width));
    const float yf = static_cast<float>(p / static_cast<uint32_t>(width));
    float o[3], d[3];
    camera_ray(cam, k0, k1, p, static_cast<uint32_t>(samp[i]) << 8, xf, yf,
               inv_w, inv_h, o[0], o[1], o[2], d[0], d[1], d[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rays[c * N + i] = o[c];
      rays[(3 + c) * N + i] = d[c];
    }
  }
}

template <int V>
cudaError_t launch_fwd(int n, const void* tab, int n_spheres,
                       const void* consts, const void* soft_tab, uint32_t k0,
                       uint32_t k1, uint32_t bounce, float t_min, float t_max,
                       int rr_start_depth, const void* state, const void* pix,
                       const void* samp, const void* prev_in, void* next,
                       void* rad, void* prev_out, void* idx_out,
                       void* bidx_out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_spheres) *
                      (kSmemPerSphere + (V != kHard ? sizeof(float4) : 0));
  int blocks = 0;
  cudaError_t err = allow_smem(grad_fwd_kernel<V>, smem);
  if (err == cudaSuccess)
    err = grid_for(grad_fwd_kernel<V>, kThreads, n, smem, blocks);
  if (err != cudaSuccess) return err;
  grad_fwd_kernel<V><<<blocks, kThreads, smem, stream>>>(
      n, static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), static_cast<const float*>(soft_tab),
      k0, k1, bounce, t_min, t_max, rr_start_depth,
      static_cast<const float*>(state), static_cast<const int*>(pix),
      static_cast<const int*>(samp), static_cast<const int*>(prev_in),
      static_cast<float*>(next), static_cast<float*>(rad),
      static_cast<int*>(prev_out), static_cast<int*>(idx_out),
      static_cast<int*>(bidx_out));
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bwd(int n, const void* tab, int n_spheres,
                       const void* consts, uint32_t k0, uint32_t k1,
                       uint32_t bounce, float t_min, float t_max,
                       int rr_start_depth, const void* state, const void* idx,
                       const void* bidx, const void* pix, const void* samp,
                       const void* ct_in, const void* ct_rad, void* ct_out,
                       void* ct_attr, void* sky_out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * kSmemPerSphere;
  int blocks = 0;
  cudaError_t err = allow_smem(grad_bwd_kernel<V>, smem);
  if (err == cudaSuccess)
    err = grid_for(grad_bwd_kernel<V>, kThreads, n, smem, blocks);
  if (err != cudaSuccess) return err;
  grad_bwd_kernel<V><<<blocks, kThreads, smem, stream>>>(
      n, static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), k0, k1, bounce, t_min, t_max,
      rr_start_depth, static_cast<const float*>(state),
      static_cast<const int*>(idx), static_cast<const int*>(bidx),
      static_cast<const int*>(pix), static_cast<const int*>(samp),
      static_cast<const float*>(ct_in), static_cast<const float*>(ct_rad),
      static_cast<float*>(ct_out), static_cast<float*>(ct_attr),
      static_cast<float*>(sky_out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spt

// One forward bounce over n rays, on the caller's stream.  variant: 0 hard,
// 1 soft (soft_tab: the scan's [n_spheres, 4] table; prev_in / prev_out
// and bidx_out used).  state: [10, n] f32 in; next: [10, n] f32 out; rad:
// [3, n] f32, added to in place; idx_out / bidx_out / prev_out: [n] i32.
// Returns cudaGetLastError() (0 = launched).
extern "C" int spt_grad_forward(
    int n, const void* tab, int n_spheres, const void* consts, int variant,
    const void* soft_tab, unsigned int k0, unsigned int k1,
    unsigned int bounce, float t_min, float t_max, int rr_start_depth,
    const void* state, const void* pix, const void* samp,
    const void* prev_in, void* next, void* rad, void* prev_out,
    void* idx_out, void* bidx_out, void* stream) {
  if (variant < 0 || variant >= spt::kVariants)
    return static_cast<int>(cudaErrorInvalidValue);
#define SPT_ARGS                                                            \
  n, tab, n_spheres, consts, soft_tab, k0, k1, bounce, t_min, t_max,        \
      rr_start_depth, state, pix, samp, prev_in, next, rad, prev_out,        \
      idx_out, bidx_out, static_cast<cudaStream_t>(stream)
  const cudaError_t err = variant == spt::kSoft
                              ? spt::launch_fwd<spt::kSoft>(SPT_ARGS)
                              : spt::launch_fwd<spt::kHard>(SPT_ARGS);
#undef SPT_ARGS
  return static_cast<int>(err);
}

// One bounce's adjoint over n rays, on the caller's stream.  ct_in /
// ct_out: [9, n] carried cotangents of (o, d, tp) after / before the
// bounce; ct_rad: [3, n]; ct_attr: [9, n] (soft [13, n]) or null to skip
// the attribute cotangents; sky_out: f32[6], zeroed by the caller, summed
// into with atomics.
extern "C" int spt_grad_backward(
    int n, const void* tab, int n_spheres, const void* consts, int variant,
    unsigned int k0, unsigned int k1, unsigned int bounce, float t_min,
    float t_max, int rr_start_depth, const void* state, const void* idx,
    const void* bidx, const void* pix, const void* samp, const void* ct_in,
    const void* ct_rad, void* ct_out, void* ct_attr, void* sky_out,
    void* stream) {
  if (variant < 0 || variant >= spt::kVariants)
    return static_cast<int>(cudaErrorInvalidValue);
#define SPT_ARGS                                                            \
  n, tab, n_spheres, consts, k0, k1, bounce, t_min, t_max, rr_start_depth,  \
      state, idx, bidx, pix, samp, ct_in, ct_rad, ct_out, ct_attr, sky_out,  \
      static_cast<cudaStream_t>(stream)
  const cudaError_t err = variant == spt::kSoft
                              ? spt::launch_bwd<spt::kSoft>(SPT_ARGS)
                              : spt::launch_bwd<spt::kHard>(SPT_ARGS);
#undef SPT_ARGS
  return static_cast<int>(err);
}

// Thin-lens camera rays for n (pixel, sample) ids: rays [6, n] f32 (origin
// xyz, unit direction xyz).  cam19: ops/persistent.py:camera_constants.
extern "C" int spt_raygen(int n, const void* cam19, unsigned int k0,
                          unsigned int k1, const void* pix, const void* samp,
                          int width, float inv_w, float inv_h, void* rays,
                          void* stream) {
  int blocks = 0;
  const cudaError_t err =
      spt::grid_for(spt::raygen_kernel, spt::kThreads, n, 0, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  spt::raygen_kernel<<<blocks, spt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(cam19), k0, k1,
      static_cast<const int*>(pix), static_cast<const int*>(samp), width,
      inv_w, inv_h, static_cast<float*>(rays));
  return static_cast<int>(cudaGetLastError());
}
