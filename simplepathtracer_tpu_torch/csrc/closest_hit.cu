// Closest-hit kernels for Hopper (sm_90a) on explicit rays.
//
// Replace the TPU kernels of the JAX package's ops/pallas_intersect.py:
//   closest_hit_kernel        _closest_hit_kernel (closest_hit_pallas):
//                             winner index and t only
//   closest_hit_attrs_kernel  _closest_hit_attrs_kernel
//                             (closest_hit_attrs_pallas): winner index, its
//                             9 float attributes and its material
// The attributes kernel serves the use_pallas_hits bounce of
// render.trace_rays; the index-and-t kernel serves
// ops/intersect.py:intersect_scene_pallas.  Both are detached: autograd
// rebuilds the differentiable hit from the winner outside.
//
// Two scans, on purpose.  closest_hit_attrs_kernel runs the shared
// common.cuh:closest_hit (the forward kernels' scan: r^2 = r * r from the
// table, sqrt of the raw discriminant, so NaN rejects and disc == 0 is
// accepted).  closest_hit_kernel keeps its TPU kernel's own formulation
// (pallas_intersect.py:59-73): r^2 from the host's radii * radii,
// sqrt(max(disc, 0)) and an explicit disc > 0 test.  The two disagree on
// tangent rays, so they share no device function.
//
// Design.  Both run as many blocks as the card keeps resident, so each
// block loads the sphere table into shared memory once; all threads of a
// warp read the same sphere at once, so the loads broadcast.  Rays are
// [N, 3] origins and directions as the JAX wrappers take them.  A dead ray
// (alive 0) skips its scan and writes the miss values (index -1, t =
// t_max; centers 0, r 1, albedo 0, material 0, fuzz 0, ior 1).  The TPU
// kernels skip only whole 1024-ray blocks that hold no live ray, so their
// output for a dead ray depends on its block; live rays get the same
// answer either way.  The winner's attributes are read once from its
// shared-memory row after the scan, where the TPU scan carries all nine
// through every select.  closest_hit_kernel runs one thread per ray in a
// grid-stride loop.  closest_hit_attrs_kernel serves every bounce of the
// hits route, and after a scatter the live rays lie scattered over the
// batch (cover at 2 spp: 100% at bounce 0, 39% at bounce 2, 1.5% at bounce
// 9), so with one thread per ray nearly every warp still held a live ray
// and scanned every sphere: each warp compacts its groups' live rays and
// scans them 32 at a time (see the kernel).
//
// Bound.  The scan's FP32 work on live rays, 20 operations per sphere test
// (persistent.cu's count): both kernels read 28 B per ray (origin,
// direction, alive) and write 8 (index, t) or 44 B (index, 9 attributes,
// material), far below the scan's time at hundreds of spheres.  Once few
// rays are live, a scan's latency on the few warps left holding them sets
// the attributes kernel's time.
//
// Numerics: --fmad=false and IEEE sqrt, as the other kernels: both match
// their plain versions (ops/closest_hit.py) bit for bit.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
// The attributes kernel's block size (at 128 it ran bounce 0 of the cover
// hits fit 5% slower on an H100), and the live rays from which a group of
// 32 runs in place instead of queueing.
constexpr int kAttrThreads = 256;
constexpr int kDense = 24;

__global__ void __launch_bounds__(kThreads) closest_hit_kernel(
    int n, const float4* __restrict__ spheres, int n_spheres,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const unsigned char* __restrict__ alive, float t_min, float t_max,
    int* __restrict__ idx_out, float* __restrict__ t_out) {
  // spheres: [n_spheres] (cx, cy, cz, r^2).
  extern __shared__ float4 smem[];
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x)
    smem[s] = spheres[s];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float bt = t_max;
    int bi = -1;
    if (alive[i]) {
      const size_t r = 3 * static_cast<size_t>(i);
      const float ox = origins[r], oy = origins[r + 1], oz = origins[r + 2];
      const float dx = dirs[r], dy = dirs[r + 1], dz = dirs[r + 2];
#pragma unroll 4
      for (int s = 0; s < n_spheres; ++s) {
        const float4 g = smem[s];
        const float ocx = g.x - ox, ocy = g.y - oy, ocz = g.z - oz;
        const float tc = ocx * dx + ocy * dy + ocz * dz;
        const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
        const float disc = g.w - (oc2 - tc * tc);
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float t_near = tc - sq;
        const float t = t_near > t_min ? t_near : tc + sq;
        if (disc > 0.0f && t > t_min && t < bt) {
          bt = t;
          bi = s;
        }
      }
    }
    idx_out[i] = bi;
    t_out[i] = bt;
  }
}

// Each warp walks its groups of 32 consecutive rays through
// common.cuh:for_each_ray_compacted: a group with at least kDense live rays
// runs in place, one ray per lane, and each lane stores its ray's outputs
// once, as with no queue (at bounce 0 every group does); of a sparser group
// the dead rays store their miss values at once and the live rays are
// scanned 32 at a time from the warp's queue.
__global__ void __launch_bounds__(kAttrThreads) closest_hit_attrs_kernel(
    int n, const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const unsigned char* __restrict__ alive, float t_min, float t_max,
    int* __restrict__ idx_out, float* __restrict__ attr_out,
    int* __restrict__ mat_out) {
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();
  const size_t N = static_cast<size_t>(n);
  // Ray i's winner (-1: a miss or a dead ray), its attributes and
  // material.
  auto work = [&](int i, bool live) {
    int bi = -1;
    if (live) {
      const size_t r = 3 * static_cast<size_t>(i);
      float bt = t_max;
      bi = closest_hit(tabs.geo, n_spheres, origins[r], origins[r + 1],
                       origins[r + 2], dirs[r], dirs[r + 1], dirs[r + 2],
                       t_min, bt);
    }
    float w[9];
    int mat;
    sphere_attrs(tabs, bi, w, mat);
    idx_out[i] = bi;
#pragma unroll
    for (int j = 0; j < 9; ++j) attr_out[j * N + i] = w[j];
    mat_out[i] = mat;
  };
  for_each_ray_compacted<kDense>(
      n, blockIdx.x * (kAttrThreads / 32) + (threadIdx.x >> 5),
      gridDim.x * (kAttrThreads / 32), [&](int i) { return alive[i] != 0; },
      work);
}

}  // namespace
}  // namespace spt

// Winner index [n] i32 (-1 on a miss or a dead ray) and t [n] f32 (t_max
// there) of n rays: origins, dirs [n, 3] f32, alive [n] bool; spheres
// [n_spheres, 4] f32 (cx, cy, cz, r^2).  On the caller's stream; returns
// cudaGetLastError() (0 = launched).
extern "C" int spt_closest_hit(int n, const void* spheres, int n_spheres,
                               const void* origins, const void* dirs,
                               const void* alive, float t_min, float t_max,
                               void* idx_out, void* t_out, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * sizeof(float4);
  int blocks = 0;
  cudaError_t err = spt::allow_smem(spt::closest_hit_kernel, smem);
  if (err == cudaSuccess)
    err = spt::grid_for(spt::closest_hit_kernel, spt::kThreads, n, smem,
                        blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  spt::closest_hit_kernel<<<blocks, spt::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float4*>(spheres), n_spheres,
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const unsigned char*>(alive), t_min, t_max,
      static_cast<int*>(idx_out), static_cast<float*>(t_out));
  return static_cast<int>(cudaGetLastError());
}

// Winner index [n] i32, attributes [9, n] f32 (cx cy cz r albedo rgb fuzz
// ior) and material [n] i32 of n rays; tab: the [n_spheres, 10] sphere
// table (cx cy cz r albedo rgb fuzz ior material).  As spt_closest_hit
// otherwise.
extern "C" int spt_closest_hit_attrs(int n, const void* tab, int n_spheres,
                                     const void* origins, const void* dirs,
                                     const void* alive, float t_min,
                                     float t_max, void* idx_out,
                                     void* attr_out, void* mat_out,
                                     void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * spt::kSmemPerSphere;
  int blocks = 0;
  cudaError_t err = spt::allow_smem(spt::closest_hit_attrs_kernel, smem);
  if (err == cudaSuccess)
    err = spt::grid_for(spt::closest_hit_attrs_kernel, spt::kAttrThreads, n,
                        smem, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  spt::closest_hit_attrs_kernel<<<blocks, spt::kAttrThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const unsigned char*>(alive), t_min, t_max,
      static_cast<int*>(idx_out), static_cast<float*>(attr_out),
      static_cast<int*>(mat_out));
  return static_cast<int>(cudaGetLastError());
}
