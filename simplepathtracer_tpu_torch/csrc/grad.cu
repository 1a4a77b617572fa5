// Per-bounce fused gradient kernels for Hopper (sm_90a): one differentiable
// bounce over explicit rays, its adjoint, and in-kernel camera rays.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad.py:
//   grad_fwd_kernel<V>   _grad_fwd_kernel   (one bounce, emits residuals)
//   grad_bwd_kernel<V>   _grad_bwd_kernel   (one bounce's adjoint)
//   raygen_kernel<kVec>  _raygen_kernel     (thin-lens rays, slots 124/125)
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
// Design.  As many blocks as the card keeps resident, so each block loads
// the sphere table into shared memory once.  A dead ray (alive 0) needs no
// scan: the forward copies its entry state and writes the JAX kernels'
// skip values (idx and bidx -1), the backward passes its carried
// cotangents through and writes zero attribute cotangents.  Both compact
// the live rays first, because after bounce 0 they are scattered over the
// batch (cover at 8 spp: 7.68 M live at bounce 0, 0.115 M at bounce 9),
// and a warp runs the scan (forward) or the adjoint (backward) as long as
// its slowest lane: a warp with 3 live lanes costs as much as one with 32.
// Each warp walks groups of 32 consecutive rays
// (group w, w + warps, ...): a lane reads its ray's alive flag, a dead
// ray gets its skip values (backward: its cotangent copy) at once
// (coalesced), and the live rays' indices go to the warp's ring in shared
// memory (ballot and popc, in ray order; the backward queues each live
// ray's 26 inputs, loaded there by the lane that classified it, so they are
// read coalesced with their group's and not gathered again).  Whenever 32
// are queued the warp runs them, one per lane, and after its last group the
// rest: every scan or adjoint but a warp's last runs on 32 live rays.
// Each live ray computes exactly what it computed with one thread per ray.
// The JAX forward also stores the winner's 9 attributes and material per
// ray; the backward here instead reads them by index from the
// shared-memory table (the one-hot gather the TPU avoided is one indexed
// load on the GPU), which saves 40 B per ray and bounce of device memory:
// 44 B of residuals per ray-bounce kept (soft 48) against the JAX
// kernels' 84 (104).  The backward reduces the sky cotangents in
// the block (warp shuffles, then shared memory) and adds them with one
// atomic per block and channel, so their last bits change from run to
// run.
//
// Bound.  The forward is bound by the sphere scan's FP32 work (20
// operations per sphere test, the soft scan ~32) on live rays; the
// backward does O(1) work per ray and is bound by the planes it reads and
// writes.  Raygen moves 32 bytes per ray, but its two 20-round threefry
// calls make it about as bound by integer issue (integer instructions run
// at half the FP32 rate): it takes no runtime division (a magic multiplier
// for 1 / width), makes 4 rays per thread with int4 loads and float4
// stores where n % 4 == 0, and runs the exact grid (PERF.md, row 8).
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt and division, as
// the other kernels: the forward, the backward's per-ray cotangents and
// raygen match their plain versions (ops/grad.py) bit for bit.

#include "bounce.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
// Live-ray ring of the forward, per warp: at most 31 left over from the
// last round plus 32 just queued.
constexpr int kQueue = 64;
constexpr int kVariants = 2;  // kHard, kSoft
// State planes [10, n]: 0-2 origin, 3-5 direction, 6-8 throughput, 9 alive.
constexpr int kAlive = 9;
// Carried cotangent planes: origin, direction, throughput.
constexpr int kCarry = 9;
// The backward's ring entries: float fields (entry state 0-8, carried
// cotangents 9-17, radiance cotangent 18-20) and int fields (the ray, its
// winner and blocker, pixel, sample).
constexpr int kRingState = 0, kRingCt = 9, kRingCtRad = 18, kRingF = 21;
constexpr int kRingRay = 0, kRingIdx = 1, kRingBidx = 2, kRingPix = 3,
              kRingSamp = 4, kRingI = 5;
// Shared memory of the backward's rings (every warp's).
constexpr size_t kRingBytes = (kThreads / 32) * (kRingF + kRingI) * kQueue * 4;

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
  // Each warp's ring of queued live-ray indices.
  __shared__ int queue[kThreads / 32][kQueue];
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

  // One live ray's bounce: the scan, bounce_forward and the stores.
  auto run = [&](int i) {
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
  };

  // Warp w classifies the groups of 32 consecutive rays w, w + n_warps, ...
  // and runs the live ones 32 at a time.
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* q = queue[threadIdx.x >> 5];
  const int n_warps = gridDim.x * (kThreads / 32);
  const int n_groups = (n + 31) / 32;
  int head = 0, count = 0;  // the ring's queued entries (warp-uniform)
  for (int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);;
       g += n_warps) {
    const bool more = g < n_groups;
    if (more) {
      const int i = g * 32 + lane;
      const bool in = i < n;
      const bool live = in && state[kAlive * N + i] > 0.0f;
      if (in && !live) {
        // Dead ray: the bounce is the identity; the skip values.
#pragma unroll
        for (int c = 0; c < kAlive; ++c) next[c * N + i] = state[c * N + i];
        next[kAlive * N + i] = 0.0f;
        idx_out[i] = -1;
        if constexpr (kSoftV) {
          bidx_out[i] = -1;
          prev_out[i] = -1;
        }
      }
      // Queue the live rays in ray order.
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) q[(head + count + __popc(m & below)) & (kQueue - 1)] = i;
      count += __popc(m);
      __syncwarp();
    }
    if (count >= 32 || (!more && count > 0)) {
      const int take = count < 32 ? count : 32;
      const int i = lane < take ? q[(head + lane) & (kQueue - 1)] : -1;
      __syncwarp();  // every lane holds its entry before the ring refills
      head = (head + take) & (kQueue - 1);
      count -= take;
      if (i >= 0) run(i);
    }
    if (!more) break;
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

// The backward's registers stay uncapped (146 hard, 168 soft, no spill): a
// bound of 3 or 4 blocks per SM (168 and 128 registers, the latter
// spilling) ran no faster on an H100.
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
  // Each warp's ring of queued live rays, after the tables (2.5 float4 per
  // slot; n_spheres is a multiple of 4): the inputs each ray's adjoint
  // reads, loaded by the lane that classified it (so the loads of a group
  // of 32 consecutive rays stay coalesced), by field.
  const int warp = threadIdx.x >> 5;
  float* const rings = reinterpret_cast<float*>(smem + 2 * n_spheres + n_spheres / 2);
  float(*rf)[kQueue] = reinterpret_cast<float(*)[kQueue]>(rings) + warp * kRingF;
  int(*ri)[kQueue] = reinterpret_cast<int(*)[kQueue]>(
                         rings + (kThreads / 32) * kRingF * kQueue) + warp * kRingI;

  // The adjoint of the live ray queued at ring slot q: the bounce rebuilt
  // from its entry state and recorded indices, bounce_adjoint, the stores,
  // the sky sum.
  auto run = [&](int q) {
    const int i = ri[kRingRay][q];
    Bounce f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = rf[kRingState + c][q];
      f.d[c] = rf[kRingState + 3 + c][q];
      f.tp[c] = rf[kRingState + 6 + c][q];
    }
    load_winner(tabs, ri[kRingIdx][q], f);
    f.do_rr = do_rr;
    const uint32_t c1b = static_cast<uint32_t>(ri[kRingSamp][q]) << 8;
    bounce_uniforms(k0, k1, static_cast<uint32_t>(ri[kRingPix][q]), c1b,
                    bounce, f.u);
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
    Soft sf;
    SoftCt sa;
    if constexpr (kSoftV) {
      const int qi = ri[kRingBidx][q];
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
      co[c] = rf[kRingCt + c][q];
      cd[c] = rf[kRingCt + 3 + c][q];
      ctp[c] = rf[kRingCt + 6 + c][q];
      ctr[c] = rf[kRingCtRad + c][q];
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
  };

  // As grad_fwd_kernel: warp w classifies the groups of 32 consecutive rays
  // w, w + n_warps, ..., passes the dead rays' cotangents through at once,
  // queues the live rays' inputs and runs their adjoints 32 at a time.
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n_warps = gridDim.x * (kThreads / 32);
  const int n_groups = (n + 31) / 32;
  int head = 0, count = 0;  // the ring's queued entries (warp-uniform)
  for (int g = blockIdx.x * (kThreads / 32) + warp;; g += n_warps) {
    const bool more = g < n_groups;
    if (more) {
      const int i = g * 32 + lane;
      const bool in = i < n;
      const bool live = in && state[kAlive * N + i] > 0.0f;
      if (in && !live) {
        // Dead ray: the bounce was the identity on (o, d, tp).
#pragma unroll
        for (int c = 0; c < kCarry; ++c) ct_out[c * N + i] = ct_in[c * N + i];
        if (ct_attr != nullptr) {
#pragma unroll
          for (int j = 0; j < kCt; ++j) ct_attr[j * N + i] = 0.0f;
        }
      }
      // Queue the live rays in ray order.
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int q = (head + count + __popc(m & below)) & (kQueue - 1);
        ri[kRingRay][q] = i;
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          rf[kRingState + c][q] = state[c * N + i];
          rf[kRingCt + c][q] = ct_in[c * N + i];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) rf[kRingCtRad + c][q] = ct_rad[c * N + i];
        ri[kRingIdx][q] = idx[i];
        if constexpr (kSoftV) ri[kRingBidx][q] = bidx[i];
        ri[kRingPix][q] = pix[i];
        ri[kRingSamp][q] = samp[i];
      }
      count += __popc(m);
      __syncwarp();
    }
    if (count >= 32 || (!more && count > 0)) {
      const int take = count < 32 ? count : 32;
      if (lane < take) run((head + lane) & (kQueue - 1));
      head = (head + take) & (kQueue - 1);
      count -= take;
      __syncwarp();  // every lane has read its entry before the ring refills
    }
    if (!more) break;
  }
  block_sum_atomic<6>(sky_acc, sky_out);
}

// Raygen: each thread makes kRaygenRays rays (its ids loaded as int4, each
// output plane stored as a float4 where the pointers and n allow; one ray
// at a time otherwise) over the exact grid.  The pixel's row and column
// come from a multiply-high by the host's magic number for 1 / width
// (Divider) in place of a division by a runtime divisor.  256-thread
// blocks: at 128 ptxas spills a register around the square root's slow-path
// call (PERF.md, row 8).
constexpr int kRaygenThreads = 256;
constexpr int kRaygenRays = 4;

// Exact p / d for every p < 2^31 (pixel ids are int32): with s = ceil(log2
// d) - 1 and m = ceil(2^(32 + s) / d), p / d = umulhi(p, m) >> s, since m d
// - 2^(32 + s) < d <= 2^(s + 1) keeps the error of p m / 2^(32 + s) below
// 1 / d (Granlund and Montgomery).  m = 0 stands for d = 1.
struct Divider {
  uint32_t m;
  int s;
};

inline Divider make_divider(uint32_t d) {
  if (d <= 1u) return {0u, 0};
  int l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const int s = l - 1;
  const uint64_t m = ((uint64_t{1} << (32 + s)) + d - 1) / d;
  return {static_cast<uint32_t>(m), s};
}

// One camera ray of pixel p and sample sid: common.cuh's camera_ray.
__device__ __forceinline__ void raygen_ray(const float (&cam)[19], uint32_t k0,
                                           uint32_t k1, uint32_t p,
                                           uint32_t sid, uint32_t width,
                                           Divider div, float inv_w,
                                           float inv_h, float (&o)[3],
                                           float (&d)[3]) {
  const uint32_t y = div.m != 0u ? __umulhi(p, div.m) >> div.s : p;
  const uint32_t x = p - y * width;
  camera_ray(cam, k0, k1, p, sid << 8, static_cast<float>(x),
             static_cast<float>(y), inv_w, inv_h, o[0], o[1], o[2], d[0],
             d[1], d[2]);
}

// kVec: n % 4 == 0 and pix, samp, rays 16-byte aligned, so a thread's rays
// 4t .. 4t + 3 are one int4 of each id array and one float4 of each plane.
// Otherwise thread t of block b makes rays 4 b blockDim + t + j blockDim
// (j < 4), each load and store coalesced across the block.  The host
// launches one block per tile of 4 blockDim rays (the exact grid); ray
// indices are 64-bit, so every n up to INT_MAX is indexed.
template <bool kVec>
__global__ void __launch_bounds__(kRaygenThreads) raygen_kernel(
    int n, const float* __restrict__ cam19, uint32_t k0, uint32_t k1,
    const int* __restrict__ pix, const int* __restrict__ samp,
    uint32_t width, Divider div, float inv_w, float inv_h,
    float* __restrict__ rays) {
  static_assert(kRaygenRays == 4, "the vector path loads one int4 per thread");
  const int64_t N = n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x * kRaygenRays;
  if (base >= N) return;
  float cam[19];
#pragma unroll
  for (int j = 0; j < 19; ++j) cam[j] = cam19[j];
  if constexpr (kVec) {
    const int64_t i0 = base + threadIdx.x * kRaygenRays;
    if (i0 >= N) return;
    const int4 p4 = *reinterpret_cast<const int4*>(pix + i0);
    const int4 s4 = *reinterpret_cast<const int4*>(samp + i0);
    const int p[4] = {p4.x, p4.y, p4.z, p4.w};
    const int s[4] = {s4.x, s4.y, s4.z, s4.w};
    float o[kRaygenRays][3], d[kRaygenRays][3];
#pragma unroll
    for (int r = 0; r < kRaygenRays; ++r)
      raygen_ray(cam, k0, k1, static_cast<uint32_t>(p[r]),
                 static_cast<uint32_t>(s[r]), width, div, inv_w, inv_h, o[r],
                 d[r]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      *reinterpret_cast<float4*>(rays + c * N + i0) =
          make_float4(o[0][c], o[1][c], o[2][c], o[3][c]);
      *reinterpret_cast<float4*>(rays + (3 + c) * N + i0) =
          make_float4(d[0][c], d[1][c], d[2][c], d[3][c]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRaygenRays; ++r) {
      const int64_t i = base + threadIdx.x + r * blockDim.x;
      if (i < N) {
        float o[3], d[3];
        raygen_ray(cam, k0, k1, static_cast<uint32_t>(pix[i]),
                   static_cast<uint32_t>(samp[i]), width, div, inv_w, inv_h,
                   o, d);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          rays[c * N + i] = o[c];
          rays[(3 + c) * N + i] = d[c];
        }
      }
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
  const size_t smem = static_cast<size_t>(n_spheres) * kSmemPerSphere + kRingBytes;
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
// Every n up to INT_MAX is taken: its grid of at most 2^21 blocks is within
// gridDim.x's limit, and the kernel indexes rays in 64 bits.
extern "C" int spt_raygen(int n, const void* cam19, unsigned int k0,
                          unsigned int k1, const void* pix, const void* samp,
                          int width, float inv_w, float inv_h, void* rays,
                          void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = n % 4 == 0 && aligned(pix) && aligned(samp) && aligned(rays);
  const int per_block = spt::kRaygenThreads * spt::kRaygenRays;
  const int blocks = (n - 1) / per_block + 1;
  const auto launch = vec ? spt::raygen_kernel<true> : spt::raygen_kernel<false>;
  launch<<<blocks, spt::kRaygenThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(cam19), k0, k1,
      static_cast<const int*>(pix), static_cast<const int*>(samp),
      static_cast<uint32_t>(width), spt::make_divider(width), inv_w, inv_h,
      static_cast<float*>(rays));
  return static_cast<int>(cudaGetLastError());
}
