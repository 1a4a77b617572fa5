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
//  * The unit of work is an item: a pixel position and one group of its
//    samples.  A launch of n_samples splits every pixel's samples into
//    n_groups = ceil(n_samples / group_len) consecutive groups (the wrapper
//    fixes group_len; n_groups depends on n_samples alone), and item i is
//    pixel position i / n_groups, group i % n_groups: pixel-major, so the
//    caller's pixel order (costliest first on the dealt routes) carries
//    over to the items, and a warp's lanes mostly run groups of one pixel,
//    whose paths start alike.  At 500 spp and 16 samples a group a pixel
//    is 32 items, so the launch's last items are a thirty-second of a
//    pixel long, where a lane summing a whole costly pixel alone set the
//    tail.
//  * A resident grid (as many 128-thread blocks as the card keeps at once,
//    so each block loads the sphere tables once) whose lanes fetch item
//    positions from a device counter: when lanes of a warp need an item,
//    one of them takes as many consecutive positions as they need with one
//    atomicAdd, and each takes its own.  The last wave of a fixed
//    lane -> item map is gone: a lane works until no position is left.
//  * One flat loop, as regen_kernel's (grad_regen.cu): every iteration is
//    one bounce of the lane's current path.  A lane whose path ended in
//    the previous iteration starts the item's next sample (a fresh camera
//    ray) or, with the item's samples done, writes the item's sums and
//    fetches the next item, inside the iteration.  So every lane reaches
//    the sphere scan in every iteration, where a loop over samples, then
//    bounces, made each sample cost the warp its longest path (the TPU
//    kernel's in-lane regeneration, here with no masks and no cross-lane
//    traffic but the fetch).
//  * Ray state stays in registers.  Each item is summed by the one lane
//    that fetched it, from 0, over its samples in order and their bounces
//    in order, and written once into row g of a [n_groups, n_pix] buffer
//    (with one group, the pixel's sums themselves): no atomics on the
//    sums.  persistent_kernel_combine then adds each pixel's n_groups
//    partial sums in group order, from 0.  So results are deterministic
//    and depend neither on which lane took an item (that changes from run
//    to run) nor on how many pixels or ranks a launch has.
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
//    item's sums when it ends, so each item is the sum of its samples'
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
// (it reads 4 B of pixel id and writes 16 B per item; the combine reads
// them back once and writes 16 B per pixel).  One sphere test
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
    uint32_t sample_offset, int n_samples, int group_len, int n_groups,
    int max_depth, int width, float inv_w, float inv_h, float t_min,
    float t_max, int rr_start_depth, const float4* __restrict__ emit,
    unsigned int* __restrict__ next_pos, float* __restrict__ out_rad,
    float* __restrict__ out_cnt) {
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
  const unsigned n_items =
      static_cast<unsigned>(n_pix) * static_cast<unsigned>(n_groups);
  unsigned at = 0;         // the item's slot: group * n_pix + pixel position
  bool has_item = false;   // at holds an item whose sums are open
  bool done = false;       // no position left for the lane
  bool alive = false;      // a path is in flight
  int s = 0, s_end = 0, b = 0;  // the item's next and end sample
  uint32_t pix = 0, c1b = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, iters = 0.0f;
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;  // the path's radiance (kEmit)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;

  for (;;) {
    // Between paths with the item's samples done: write its sums, then
    // fetch the next position (one atomic for the warp's fetching lanes).
    const bool fetch = !done && !alive && (!has_item || s >= s_end);
    if (fetch && has_item) {
      out_rad[3 * static_cast<size_t>(at) + 0] = acc_r;
      out_rad[3 * static_cast<size_t>(at) + 1] = acc_g;
      out_rad[3 * static_cast<size_t>(at) + 2] = acc_b;
      if (out_cnt != nullptr) out_cnt[at] = iters;
    }
    const unsigned m = __ballot_sync(kFullWarp, fetch);
    if (m != 0u) {
      const int leader = __ffs(m) - 1;
      unsigned base = 0;
      if (lane == leader) base = atomicAdd(next_pos, static_cast<unsigned>(__popc(m)));
      base = __shfl_sync(kFullWarp, base, leader);
      if (fetch) {
        const unsigned item = base + static_cast<unsigned>(__popc(m & below));
        has_item = item < n_items;
        done = !has_item;
        if (has_item) {
          const unsigned pos = item / static_cast<unsigned>(n_groups);
          const unsigned g = item - pos * static_cast<unsigned>(n_groups);
          at = g * static_cast<unsigned>(n_pix) + pos;
          pix = static_cast<uint32_t>(pixel_ids[pos]);
          s = static_cast<int>(g) * group_len;
          s_end = min(s + group_len, n_samples);
          acc_r = acc_g = acc_b = iters = 0.0f;
        }
      }
    }
    if (__all_sync(kFullWarp, done)) break;
    if (done) continue;

    if (!alive) {
      // The item's next sample: a fresh camera ray.
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

// Each pixel's sums from the [n_groups, n_pix] partial sums of its sample
// groups, added in group order from 0: one thread per radiance channel
// (3 n_pix), then one per count (n_pix, where part_cnt is given).
__global__ void __launch_bounds__(256) persistent_kernel_combine(
    const float* __restrict__ part_rad, const float* __restrict__ part_cnt,
    int n_pix, int n_groups, float* __restrict__ out_rad,
    float* __restrict__ out_cnt) {
  const long long n_rad = 3LL * n_pix;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* part = part_rad;
  float* out = out_rad;
  long long j = i, stride = n_rad;
  if (i >= n_rad) {
    if (part_cnt == nullptr || i >= n_rad + n_pix) return;
    part = part_cnt;
    out = out_cnt;
    j = i - n_rad;
    stride = n_pix;
  }
  float acc = 0.0f;
  for (int g = 0; g < n_groups; ++g) acc += part[g * stride + j];
  out[j] = acc;
}

}  // namespace
}  // namespace spt

namespace spt {
namespace {

constexpr int kCombineThreads = 256;

// The resident grid of one build for n_items work items over n_spheres
// table slots.
template <bool kEmit>
cudaError_t persistent_grid(long long n_items, int n_spheres, size_t& smem,
                            int& blocks) {
  smem = static_cast<size_t>(n_spheres) * kSmemPerSphere;
  cudaError_t err = allow_smem(persistent_kernel<kEmit>, smem);
  if (err == cudaSuccess)
    err = grid_for(persistent_kernel<kEmit>, kThreads, n_items, smem, blocks);
  return err;
}

template <bool kEmit>
cudaError_t persistent_launch(
    const void* pixel_ids, int n_pix, const void* tab, int n_spheres,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_samples, int group_len, int n_groups,
    int max_depth, int width, float inv_w, float inv_h, float t_min,
    float t_max, int rr_start_depth, const void* emit, void* next_pos,
    void* part_rad, void* part_cnt, void* out_rad, void* out_cnt,
    void* stream) {
  size_t smem = 0;
  int blocks = 0;
  const long long n_items = static_cast<long long>(n_pix) * n_groups;
  cudaError_t err = persistent_grid<kEmit>(n_items, n_spheres, smem, blocks);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One group: the items are the pixels, and write their sums directly.
  const bool split = n_groups > 1;
  persistent_kernel<kEmit><<<blocks, kThreads, smem, st>>>(
      static_cast<const int*>(pixel_ids), n_pix,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, group_len, n_groups, max_depth, width, inv_w, inv_h, t_min,
      t_max, rr_start_depth, static_cast<const float4*>(emit),
      static_cast<unsigned int*>(next_pos),
      static_cast<float*>(split ? part_rad : out_rad),
      static_cast<float*>(split ? part_cnt : out_cnt));
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long n_out = 3LL * n_pix + (out_cnt != nullptr ? n_pix : 0);
  const int combine_blocks =
      static_cast<int>((n_out + kCombineThreads - 1) / kCombineThreads);
  persistent_kernel_combine<<<combine_blocks, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_rad),
      out_cnt != nullptr ? static_cast<const float*>(part_cnt) : nullptr,
      n_pix, n_groups, static_cast<float*>(out_rad),
      static_cast<float*>(out_cnt));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spt

// Blocks of 128 lanes that spt_persistent_render launches (the build
// without emission) for n_items work items (pixels x sample groups) over
// n_spheres table slots, into *blocks (an int).
extern "C" int spt_persistent_grid(int n_items, int n_spheres, void* blocks) {
  size_t smem = 0;
  return static_cast<int>(spt::persistent_grid<false>(
      n_items, n_spheres, smem, *static_cast<int*>(blocks)));
}

// Launch on the caller's stream.  emit: nullptr (the build without
// emission) or n_spheres float4 (emission rgb, 0), 16-byte aligned.
// n_groups = ceil(n_samples / group_len) sample groups a pixel, with
// n_pix * n_groups < 2^31.  next_pos: one u32, zeroed by the caller (the
// item counter).  part_rad / part_cnt: with n_groups > 1, [n_groups, n_pix]
// scratch (3 floats / 1 float an entry; part_cnt where out_cnt is given)
// that persistent_kernel_combine then adds into out_rad / out_cnt; unused
// with one group.  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_persistent_render(
    const void* pixel_ids, int n_pix, const void* tab, int n_spheres,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_samples, int group_len, int n_groups,
    int max_depth, int width, float inv_w, float inv_h, float t_min,
    float t_max, int rr_start_depth, const void* emit, void* next_pos,
    void* part_rad, void* part_cnt, void* out_rad, void* out_cnt,
    void* stream) {
  const auto launch = emit != nullptr ? spt::persistent_launch<true>
                                      : spt::persistent_launch<false>;
  return static_cast<int>(launch(
      pixel_ids, n_pix, tab, n_spheres, consts, use_plane, k0, k1,
      sample_offset, n_samples, group_len, n_groups, max_depth, width, inv_w,
      inv_h, t_min, t_max, rr_start_depth, emit, next_pos, part_rad, part_cnt,
      out_rad, out_cnt, stream));
}
