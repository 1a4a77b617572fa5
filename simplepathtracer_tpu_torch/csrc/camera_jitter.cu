// Camera jitter for Hopper (sm_90a): per ray the four uniforms of its
// camera ray, [n, 4] f32 -- columns 0-1 the pixel jitter (threefry slot
// 124), 2-3 the lens disk (slot 125) -- for render.render_pixels' eager
// camera rays (camera.generate_rays): the camera-gradient fused route, plane
// scenes on the fused route, the plain autograd route on CUDA and the hits
// route.  (The raygen route makes its rays in raygen_kernel, grad.cu.)
//
// Replaces no pallas_call: the JAX package's ops/sampling.py:camera_jitter
// is jnp code that XLA fuses into one TPU fusion.  Run eagerly, its plain
// version (ops/sampling.py:camera_jitter_reference) launches ~350
// elementwise kernels a call (two 20-round threefry2x32 evaluations on
// int64 tensors, masked to 32 bits after every add and shift, and four
// word-to-float conversions), each streaming [n] int64 operands through
// device memory: ~0.2 s of the ~0.59 s decoupled camera-fit step on the
// cover frame, whose two calls a step take 48 M rays each.
//
// Bound.  Per ray it reads 16 B (the int64 pixel and sample ids as
// ops/sampling.py:ray_keys leaves them; their low 32 bits are the u32
// counters, so the route needs no cast kernel) and writes 16 B (one
// float4): 48 M rays move 1.54 GB, 0.46 ms at 3.35 TB/s.  Its integer work
// is ~150 operations per ray (common.cuh's threefry2x32 twice, 143 with
// the shared pix + k0; the counters sid << 8 | 124 and | 125; the four
// words' >> 8), 0.43 ms at the card's integer rate (64 results per clock
// per SM): about 0.5 ms a call either way.
//
// Design.  As raygen_kernel: 4 rays per thread, one block of 256 threads
// per tile of 1024 rays (the exact grid), 64-bit ray indices, so every n
// the grid holds (2^31 - 1 blocks) is indexed.  Thread t of block b makes
// rays 1024 b + t + 256 j (j < 4): each warp's id loads (8 B a lane) and
// float4 stores (16 B a lane) are one contiguous run, every 32-byte sector
// whole; the last tile of a ragged n tests each ray (the scalar tail).
// Raygen's wide loads (a thread's rays 4t .. 4t + 3, two 16-byte loads of
// each id array and four float4 stores) ran slower here, 0.5665 ms against
// 0.5203 at 48 M rays on an H100 (PERF.md, row 12): with [n, 4] rows, each
// of a warp's store instructions then fills half of 32 sectors.  The
// threefry and the conversion are common.cuh's (uniforms), as raygen's:
// integer work, and the float is the word's top 24 bits times 2^-24, exact,
// so the uniforms equal the plain version's bit for bit.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kJitterThreads = 256;
constexpr int kJitterRays = 4;

// The two camera evaluations of one ray: slot 124 (pixel jitter) in x, y,
// slot 125 (lens disk) in z, w.  The int64 ids wrap to their low 32 bits,
// as the plain version masks them.
__device__ __forceinline__ float4 jitter(uint32_t k0, uint32_t k1, int64_t pix,
                                         int64_t sid) {
  const uint32_t p = static_cast<uint32_t>(pix);
  const uint32_t c1b = static_cast<uint32_t>(sid) << 8;
  float4 u;
  uniforms(k0, k1, p, c1b | 124u, u.x, u.y);
  uniforms(k0, k1, p, c1b | 125u, u.z, u.w);
  return u;
}

__global__ void __launch_bounds__(kJitterThreads) camera_jitter_kernel(
    int64_t n, uint32_t k0, uint32_t k1, const int64_t* __restrict__ pix,
    const int64_t* __restrict__ samp, float4* __restrict__ out) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kJitterThreads * kJitterRays + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kJitterRays; ++r) {
    const int64_t i = base + r * kJitterThreads;
    if (i < n) out[i] = jitter(k0, k1, pix[i], samp[i]);
  }
}

}  // namespace
}  // namespace spt

// Camera uniforms [n, 4] f32 (out, 16-byte aligned) of n rays from their
// int64 pixel and sample ids (pix, samp) under the key (k0, k1), on the
// caller's stream.  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_camera_jitter(long long n, unsigned int k0, unsigned int k1,
                                 const void* pix, const void* samp, void* out,
                                 void* stream) {
  const long long per_block = spt::kJitterThreads * spt::kJitterRays;
  if (n <= 0 || (n - 1) / per_block >= 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((n - 1) / per_block + 1);
  spt::camera_jitter_kernel<<<blocks, spt::kJitterThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      n, k0, k1, static_cast<const int64_t*>(pix), static_cast<const int64_t*>(samp),
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
