// One forward bounce over explicit rays for Hopper (sm_90a): the
// explicit-ray forward of render.trace_rays_pallas.
//
// Replaces the TPU kernel ops/pallas_bounce.py:_bounce_kernel of the JAX
// package (bounce_step_pallas).  Ray i of a batch of n carries SoA state
// planes [13, n]: origin 0:3, direction 3:6, throughput 6:9, radiance
// 9:12, alive 12; its pixel and sample ids are [n] i32.  The host launches
// it max_depth times, bounce b reading the state bounce b - 1 wrote.
//
// What it computes, on a live ray, in the TPU kernel's arithmetic (which
// is not the persistent kernel's): the shared scan common.cuh:closest_hit
// (the winner's attributes read from its shared-memory row), the ground
// plane merged as plane_override merges it, the hit point and normal, the
// 8 bounce uniforms (counter samp << 8 | 4 b + e), the sky added to the
// radiance on a miss before the scatter, the scatter, then
//     o' = o + (p - o) * [hit]         d' = d + (s - d) * [survives]
// as lerps by 0/1 masks, not selects (on a live hit the lerp can round
// away from p), the direction updated with the survival mask from before
// Russian roulette, and RR at bounce >= rr_start_depth > 0 with
// q = clip(max(throughput after the attenuation), 0.05, 1), killing where
// u6 >= q and multiplying the survivors' throughput by 1 / q.
//
// Design.  As many blocks as the card keeps resident, so each block loads
// the sphere table into shared memory once.  After the first bounce the
// live rays lie scattered over the batch (cover at 8 spp: 84% live at
// bounce 1, 11% at bounce 4, 1.5% at bounce 9), so with one thread per
// ray nearly every warp would hold a live ray and run the whole scan while
// its dead threads wait (summed over the 10 bounces, 5.8 batches of warps
// for 2.7 batches of live rays).  So each warp compacts its groups' live rays
// (common.cuh:for_each_ray_compacted, as closest_hit_attrs_kernel): a group
// of 32 consecutive rays with at least kDense live rays runs in place, one
// ray per lane, its dead and live rays storing in the same instructions
// (at bounce 0 every group does); of a sparser group the dead rays copy
// their state at once and the live rays run 32 at a time from the warp's
// queue.  A dead ray (alive 0) copies its state and writes alive 0.  The
// TPU kernel skips only whole 1024-ray blocks with no live ray and runs
// the masked bounce on the dead rays of the others, whose lerps then leave
// their state unchanged up to the sign of a zero; the output for dead rays
// is not part of the contract.  Each thread computes only its own
// material's scatter (common.cuh:scatter), where the TPU kernel computes
// all three and selects: the chosen branch's operations are the same.
//
// Bound.  The scan's FP32 work on live rays, 20 operations per sphere test
// (persistent.cu's count); the bytes are 15 planes read and 13 written per
// ray, 112 B.
//
// Numerics: --fmad=false and IEEE sqrt and division, as the other kernels:
// it matches its plain version (ops/bounce_step.py) bit for bit.

#include "common.cuh"

namespace spt {
namespace {

// Threads per block (at 128 the cover render_pixels bounces ran ~3% slower
// on an H100), and the live rays from which a group of 32 runs in place
// instead of queueing.
constexpr int kThreads = 256;
constexpr int kDense = 24;
// State planes [13, n]: origin, direction, throughput, radiance, alive.
constexpr int kAlive = 12;

__global__ void __launch_bounds__(kThreads) bounce_step_kernel(
    int n, const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t bounce, float t_min, float t_max, int rr_start_depth,
    const float* __restrict__ state, const int* __restrict__ pix,
    const int* __restrict__ samp, float* __restrict__ next) {
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();
  // consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo).
  float sky[6], pl[7];
#pragma unroll
  for (int j = 0; j < 6; ++j) sky[j] = consts[j];
#pragma unroll
  for (int j = 0; j < 7; ++j) pl[j] = consts[6 + j];
  const size_t N = static_cast<size_t>(n);
  const bool do_rr =
      rr_start_depth > 0 && static_cast<int>(bounce) >= rr_start_depth;
  // Ray i's next state: its bounce if live, else a copy of its state with
  // alive 0.
  auto work = [&](int i, bool live) {
    float o[3], d[3], tp[3], rad[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = state[c * N + i];
      d[c] = state[(3 + c) * N + i];
      tp[c] = state[(6 + c) * N + i];
      rad[c] = state[(9 + c) * N + i];
    }
    bool surv = false;
    if (live) {
      float bt = t_max;
      const int bi = closest_hit(tabs.geo, n_spheres, o[0], o[1], o[2], d[0],
                                 d[1], d[2], t_min, bt);
      float w[9];
      int mat;
      sphere_attrs(tabs, bi, w, mat);
      bool hit = bi >= 0;
      float tpl, sgn;
      if (use_plane &&
          plane_wins(pl, o[0], o[1], o[2], d[0], d[1], d[2], t_min, bt, tpl,
                     sgn)) {
        // plane_override: a virtual unit sphere tangent at the hit point.
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c] = (o[c] + tpl * d[c]) - sgn * pl[c];
        w[3] = 1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) w[4 + c] = pl[4 + c];
        w[7] = 0.0f;
        w[8] = 1.0f;
        mat = kLambertian;
        bt = tpl;
        hit = true;
      }
      // Hit point and outward normal (hit_point_normal).
      float p[3], nrm[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = o[c] + bt * d[c];
        nrm[c] = (p[c] - w[c]) / w[3];
      }
      const float inv = rsqrtf(nrm[0] * nrm[0] + nrm[1] * nrm[1] +
                               nrm[2] * nrm[2] + 1e-20f);
#pragma unroll
      for (int c = 0; c < 3; ++c) nrm[c] = nrm[c] * inv;

      float u[8];
      bounce_uniforms(k0, k1, static_cast<uint32_t>(pix[i]),
                      static_cast<uint32_t>(samp[i]) << 8, bounce, u);
      // Sky on a live miss, before the scatter.
      const float s01 = 0.5f * (d[1] + 1.0f);
      const float mf = hit ? 0.0f : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rad[c] = rad[c] + tp[c] * (sky[c] + (sky[3 + c] - sky[c]) * s01) * mf;

      float sd[3];
      bool is_diel;
      const bool scattered = scatter(d[0], d[1], d[2], nrm[0], nrm[1], nrm[2],
                                     mat, w[7], w[8], u, sd[0], sd[1], sd[2],
                                     is_diel);
      surv = hit && scattered;
      const float lf = hit ? 1.0f : 0.0f;
      const float sf = surv ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tp[c] = tp[c] * (surv && !is_diel ? w[4 + c] : 1.0f);
        o[c] = o[c] + (p[c] - o[c]) * lf;
        d[c] = d[c] + (sd[c] - d[c]) * sf;
      }
      if (rr_start_depth > 0) {
        const float q =
            fminf(fmaxf(fmaxf(fmaxf(tp[0], tp[1]), tp[2]), 0.05f), 1.0f);
        surv = surv && !(do_rr && u[6] >= q);
        const float boost = do_rr && surv ? 1.0f / q : 1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) tp[c] = tp[c] * boost;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      next[c * N + i] = o[c];
      next[(3 + c) * N + i] = d[c];
      next[(6 + c) * N + i] = tp[c];
      next[(9 + c) * N + i] = rad[c];
    }
    next[kAlive * N + i] = surv ? 1.0f : 0.0f;
  };
  for_each_ray_compacted<kDense>(
      n, blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5),
      gridDim.x * (kThreads / 32),
      [&](int i) { return state[kAlive * N + i] > 0.0f; }, work);
}

}  // namespace
}  // namespace spt

// One bounce over n rays, on the caller's stream.  tab: the [n_spheres, 10]
// sphere table; consts: f32[13] (sky 0:6, plane 6:13, read when
// use_plane); state: [13, n] f32 in; pix, samp: [n] i32; next: [13, n] f32
// out.  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_bounce_step(int n, const void* tab, int n_spheres,
                               const void* consts, int use_plane,
                               unsigned int k0, unsigned int k1,
                               unsigned int bounce, float t_min, float t_max,
                               int rr_start_depth, const void* state,
                               const void* pix, const void* samp, void* next,
                               void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * spt::kSmemPerSphere;
  int blocks = 0;
  cudaError_t err = spt::allow_smem(spt::bounce_step_kernel, smem);
  if (err == cudaSuccess)
    err = spt::grid_for(spt::bounce_step_kernel, spt::kThreads, n, smem,
                        blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  spt::bounce_step_kernel<<<blocks, spt::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, bounce, t_min,
      t_max, rr_start_depth, static_cast<const float*>(state),
      static_cast<const int*>(pix), static_cast<const int*>(samp),
      static_cast<float*>(next));
  return static_cast<int>(cudaGetLastError());
}
