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
//  * A resident grid (as many 128-thread blocks as the card keeps at once,
//    so each block loads the sphere tables once) whose lanes fetch pixel
//    positions from a device counter: when lanes of a warp need a pixel,
//    one of them takes as many consecutive positions as they need with one
//    atomicAdd, and each takes its own.  The last wave of a fixed
//    lane -> pixel map is gone: a lane works until no position is left.
//  * One flat loop, as regen_kernel's (grad_regen.cu): every iteration is
//    one bounce of the lane's current path.  A lane whose path ended in
//    the previous iteration starts the pixel's next sample (a fresh camera
//    ray) or, with the pixel's samples done, writes the pixel's sums and
//    fetches the next pixel, inside the iteration.  So every lane reaches
//    the sphere scan in every iteration, where a loop over samples, then
//    bounces, made each sample cost the warp its longest path (the TPU
//    kernel's in-lane regeneration, here with no masks and no cross-lane
//    traffic but the fetch).
//  * Ray state stays in registers.  Each pixel is summed by the one lane
//    that fetched it, over its samples in order and their bounces in
//    order, and written once: no atomics on the sums, so results are
//    deterministic and do not depend on which lane took the pixel (that
//    changes from run to run).
//  * Sphere tables are loaded once per block into shared memory as packed
//    float4 (cx, cy, cz, r), float4 (albedo rgb, fuzz), float2 (ior,
//    material).  All threads of a warp read the same sphere at once, so the
//    loads broadcast.  The scan tracks only (t, index); the winner's
//    attributes are read once after it.  r^2 is recomputed from r, so a
//    padding slot with a NaN radius rejects itself for every ray.
//  * The device functions it shares with the gradient kernels (threefry,
//    camera ray, sphere scan, plane test, scatter) live in common.cuh.
//  * Emission is a compile-time switch (kEmit): the true build adds, at
//    every sphere hit, the path's throughput before the hit's attenuation
//    times the winner's emission, read from a [S] float4 table in global
//    memory after the scan (one read per hit, served by L1), before
//    scatter, absorption, the depth limit or roulette decide whether the
//    path goes on.  The plane emits nothing.  A path of the true build
//    sums its own radiance (emission, then the sky) and adds it to the
//    pixel's sums when it ends, so each pixel is the sum of its samples'
//    path radiances in sample order, as the plain version adds them.  The
//    false build (every scene without emission: at most one term a path)
//    keeps the scan's shared-memory layout and its arithmetic; the
//    wrapper launches the true build only for a table with a non-zero
//    entry.
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
// registers, and a lane starts its next path in the iteration after its
// last one ended, so the count of sphere tests is what the paths need.
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
// Blocks per SM the launch bounds ask for: 8 x 128 lanes caps the kernel at
// 64 registers (80 without the cap, 6 blocks per SM); the 8-block build was
// the faster of the two on an H100 at the cover frame.
constexpr int kBlocksPerSm = 8;

template <bool kEmit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) persistent_kernel(
    const int* __restrict__ pixel_ids, int n_pix,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    const float4* __restrict__ emit, unsigned int* __restrict__ next_pos,
    float* __restrict__ out_rad, float* __restrict__ out_cnt) {
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();

  // consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32
  // (origin, lower_left, horizontal, vertical, u, v, lens radius).
  float sky[6], pl[7], cam[19];
#pragma unroll
  for (int i = 0; i < 6; ++i) sky[i] = consts[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) pl[i] = consts[6 + i];
#pragma unroll
  for (int i = 0; i < 19; ++i) cam[i] = consts[13 + i];

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned pos = 0;        // the lane's pixel position
  bool has_pixel = false;  // pos holds a pixel whose sums are open
  bool done = false;       // no position left for the lane
  bool alive = false;      // a path is in flight
  int s = 0, b = 0;
  uint32_t pix = 0, c1b = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, iters = 0.0f;
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;  // the path's radiance (kEmit)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;

  for (;;) {
    // Between paths with the pixel's samples done: write its sums, then
    // fetch the next position (one atomic for the warp's fetching lanes).
    const bool fetch = !done && !alive && (!has_pixel || s >= n_samples);
    if (fetch && has_pixel) {
      out_rad[3 * static_cast<size_t>(pos) + 0] = acc_r;
      out_rad[3 * static_cast<size_t>(pos) + 1] = acc_g;
      out_rad[3 * static_cast<size_t>(pos) + 2] = acc_b;
      if (out_cnt != nullptr) out_cnt[pos] = iters;
    }
    const unsigned m = __ballot_sync(kFullWarp, fetch);
    if (m != 0u) {
      const int leader = __ffs(m) - 1;
      unsigned base = 0;
      if (lane == leader) base = atomicAdd(next_pos, static_cast<unsigned>(__popc(m)));
      base = __shfl_sync(kFullWarp, base, leader);
      if (fetch) {
        pos = base + static_cast<unsigned>(__popc(m & below));
        has_pixel = pos < static_cast<unsigned>(n_pix);
        done = !has_pixel;
        if (has_pixel) {
          pix = static_cast<uint32_t>(pixel_ids[pos]);
          s = 0;
          acc_r = acc_g = acc_b = iters = 0.0f;
        }
      }
    }
    if (__all_sync(kFullWarp, done)) break;
    if (done) continue;

    if (!alive) {
      // The pixel's next sample: a fresh camera ray.
      c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
      const float xf = static_cast<float>(pix % static_cast<uint32_t>(width));
      const float yf = static_cast<float>(pix / static_cast<uint32_t>(width));
      camera_ray(cam, k0, k1, pix, c1b, xf, yf, inv_w, inv_h, ox, oy, oz, dx,
                 dy, dz);
      tr = tg = tb = 1.0f;
      if constexpr (kEmit) lr = lg = lb = 0.0f;
      b = 0;
      alive = true;
    }

    // One bounce of the path.
    iters += 1.0f;
    float bt = t_max;
    const int bi = closest_hit(tabs.geo, n_spheres, ox, oy, oz, dx, dy, dz,
                               t_min, bt);
    bool hit = bi >= 0;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f, r = 1.0f;
    float ar = 0.0f, ag = 0.0f, ab = 0.0f, fz = 0.0f, io = 1.0f;
    int mat = kLambertian;
    float er = 0.0f, eg = 0.0f, eb = 0.0f;
    if (hit) {
      const float4 g = tabs.geo[bi], a = tabs.att[bi];
      const float2 a2 = tabs.att2[bi];
      cx = g.x; cy = g.y; cz = g.z; r = g.w;
      ar = a.x; ag = a.y; ab = a.z; fz = a.w;
      io = a2.x;
      mat = static_cast<int>(a2.y);
      if constexpr (kEmit) {
        const float4 e = __ldg(emit + bi);
        er = e.x; eg = e.y; eb = e.z;
      }
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
      er = eg = eb = 0.0f;
      bt = tp;
      hit = true;
    }
    bool ends = true;
    if (!hit) {
      // Sky on a live miss, then the path ends.
      const float h = 0.5f * (dy + 1.0f);
      const float sr = tr * (sky[0] + (sky[3] - sky[0]) * h);
      const float sg = tg * (sky[1] + (sky[4] - sky[1]) * h);
      const float sb = tb * (sky[2] + (sky[5] - sky[2]) * h);
      if constexpr (kEmit) {
        lr += sr; lg += sg; lb += sb;
      } else {
        acc_r += sr; acc_g += sg; acc_b += sb;
      }
    } else {
      if constexpr (kEmit) {
        // Light the hit surface emits, through the path so far.
        lr += tr * er;
        lg += tg * eg;
        lb += tb * eb;
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
      const bool scattered = scatter(dx, dy, dz, nx, ny, nz, mat, fz, io, u,
                                     sdx, sdy, sdz, is_diel);
      if (scattered && b + 1 < max_depth) {
        if (!is_diel) {
          tr *= ar; tg *= ag; tb *= ab;
        }
        bool rr_kill = false;
        if (rr_start_depth > 0 && b >= rr_start_depth) {
          // Russian roulette on the throughput after this bounce.
          const float q = fminf(fmaxf(fmaxf(fmaxf(tr, tg), tb), 0.05f), 1.0f);
          float u6, unused;
          uniforms(k0, k1, pix, c1b | (slot0 + 3u), u6, unused);
          rr_kill = u6 >= q;
          if (!rr_kill) {
            const float boost = 1.0f / q;
            tr *= boost; tg *= boost; tb *= boost;
          }
        }
        if (!rr_kill) {
          ox = px; oy = py; oz = pz;
          dx = sdx; dy = sdy; dz = sdz;
          ++b;
          ends = false;
        }
      }
    }
    if (ends) {
      if constexpr (kEmit) {
        acc_r += lr;
        acc_g += lg;
        acc_b += lb;
      }
      alive = false;
      ++s;
    }
  }
}

}  // namespace
}  // namespace spt

namespace spt {
namespace {

// The resident grid of one build for n_pix pixels over n_spheres table
// slots.
template <bool kEmit>
cudaError_t persistent_grid(int n_pix, int n_spheres, size_t& smem,
                            int& blocks) {
  smem = static_cast<size_t>(n_spheres) * kSmemPerSphere;
  cudaError_t err = allow_smem(persistent_kernel<kEmit>, smem);
  if (err == cudaSuccess)
    err = grid_for(persistent_kernel<kEmit>, kThreads, n_pix, smem, blocks);
  return err;
}

template <bool kEmit>
cudaError_t persistent_launch(
    const void* pixel_ids, int n_pix, const void* tab, int n_spheres,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    const void* emit, void* next_pos, void* out_rad, void* out_cnt,
    void* stream) {
  size_t smem = 0;
  int blocks = 0;
  const cudaError_t err =
      persistent_grid<kEmit>(n_pix, n_spheres, smem, blocks);
  if (err != cudaSuccess) return err;
  persistent_kernel<kEmit><<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pixel_ids), n_pix,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      static_cast<const float4*>(emit), static_cast<unsigned int*>(next_pos),
      static_cast<float*>(out_rad), static_cast<float*>(out_cnt));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spt

// Blocks of 128 lanes that spt_persistent_render launches (the build
// without emission) for n_pix pixels over n_spheres table slots, into
// *blocks (an int).
extern "C" int spt_persistent_grid(int n_pix, int n_spheres, void* blocks) {
  size_t smem = 0;
  return static_cast<int>(spt::persistent_grid<false>(
      n_pix, n_spheres, smem, *static_cast<int*>(blocks)));
}

// Launch on the caller's stream.  emit: nullptr (the build without
// emission) or n_spheres float4 (emission rgb, 0), 16-byte aligned.
// next_pos: one u32, zeroed by the caller (the pixel counter).  Returns
// cudaGetLastError() (0 = launched).
extern "C" int spt_persistent_render(
    const void* pixel_ids, int n_pix, const void* tab, int n_spheres,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    const void* emit, void* next_pos, void* out_rad, void* out_cnt,
    void* stream) {
  const auto launch = emit != nullptr ? spt::persistent_launch<true>
                                      : spt::persistent_launch<false>;
  return static_cast<int>(launch(
      pixel_ids, n_pix, tab, n_spheres, consts, use_plane, k0, k1,
      sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min, t_max,
      rr_start_depth, emit, next_pos, out_rad, out_cnt, stream));
}
