// Regeneration gradient kernels for Hopper (sm_90a): the recording forward
// (two modes), the scan-free re-forward and the backward, hard and with
// two-sided soft silhouettes.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad_regen.py:
//   regen_kernel<kModeFull, V>   _regen_fwd_kernel, emit_full=True
//   regen_idx_kernel<V>          _regen_fwd_kernel, emit_idx_only=True
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
// Design.  A lane's ray state lives in registers, and each iteration of a
// lane is one step (regen_step), the same arithmetic in every mode.  Planes
// are [n_iter, n_lanes] (iteration-major).  A lane's live iterations are 0
// .. count - 1 (it regenerates at once until its banks are done); the
// iterations after read as dead (alive 0, idx and bidx -1, packed words 0).
// The idx-only recording forward (regen_idx_kernel, the streamed main
// path's) runs a resident grid whose threads fetch lanes from a device
// counter, as persistent.cu fetches pixels: a thread that ends its lane
// takes the next inside the same loop, so a warp runs until the card has
// no lane left, not until its longest lane ends, and the grid has no last
// wave; which thread runs a lane changes from run to run, no value does.
// Its words after a lane's end are zeroed by the wrapper before the
// launch.  The full-residual forward and the re-forward (regen_kernel) keep
// one thread per lane, so their 25-30 plane stores per iteration coalesce
// (on lanes that drift apart they did not, and the hard full forward took
// 1.7x as long), and each warp walks its iterations in step, so the dead
// entries (three quarters of a cover chunk's) are stored row by row: inside
// the warp's live span in the live lanes' store instructions, after it as
// stores alone.  Sphere tables
// sit in shared memory (common.cuh); the re-forward reads its winner and
// blocker by index there instead of the TPU's one-hot matrix product.
// Per-lane partials are written once and summed by the host, so every
// result is deterministic.
//
// The backward (regen_bwd_kernel) also keeps one thread per lane.  About
// three quarters of a chunk's (iteration, lane) entries are dead (the
// cover fit's chunks: 26% live hard, 25% soft), and their zero cotangents
// are about half of its bytes.  So each lane finds its count by a binary
// search over its alive column, each warp walks back only from its lanes'
// longest count, and the iterations above it are stored as zeros with
// nothing read.  A live iteration's 24-29 input planes are copied into
// shared memory one iteration ahead (cp.async, two stages), so their
// latency hides behind the previous iteration's adjoint: its registers
// (128-168, spilling a little under the launch bounds) leave room for
// 3-4 blocks of 128 threads per SM.  A lane above its count stores its
// zeros in the same instructions as the live lanes' cotangents.
//
// Bound.  The recording forward is bound by the sphere scan's FP32 work,
// as the persistent kernel (20 operations per sphere test; the soft scan
// ~30); the re-forward and backward do O(1) work per iteration and are
// bound by the planes they write and read (25 planes out; 25 in and 9 out;
// soft: 30 out; 30 in and 13 out).  The soft backward's adjoint is long
// enough (~750 FP32 operations per live iteration, at 3 blocks per SM)
// that its arithmetic's latency, not its bytes, sets its time.
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt / division: every
// operation rounds as the PyTorch elementwise op of the plain versions
// (ops/grad_regen.py, ops/bounce.py), so the kernels match them bit for
// bit.  Where the plain version divides a constant by a tensor, PyTorch
// computes reciprocal(x) * c; the code below does the same.  logf and expf
// are the CUDA math library's, as PyTorch's log and exp on the card.

#include <cuda_pipeline_primitives.h>

#include "bounce.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
// Blocks per SM the launch bounds of the forward kernels ask for.  The
// idx-only forward: 7 x 128 threads cap it at 72 registers (the soft scan
// needs 70 without a spill; at 8 blocks, 64 registers, it spilled and ran
// 6% slower on an H100).  The re-forward: 6 (80 registers; at 7 it ran
// ~4% slower on an H100, at 8 ~2% slower again; unbounded it took 94 and
// ran at 5 blocks per SM).  The full-residual forward: 8 (64 registers;
// ~3% faster than at 7, ~8% faster than at 6).
constexpr int kRegenBlocksPerSm = 7;
constexpr int kModeFull = 0;
constexpr int kModeIdx = 1;
constexpr int kModeRefwd = 2;
template <int MODE>
constexpr int kPlaneBlocksPerSm = MODE == kModeRefwd ? 6 : 8;
// f32 residual planes: 0-2 o, 3-5 d, 6-8 tp, 9 alive, 10 regen, 11-19 the
// winner's cx cy cz r ar ag ab fuzz ior; soft: 20-23 the blocker's cx cy cz
// r.  i32: 0 kb, 1 s, 2 b, 3 idx, 4 mat; soft: 5 the blocker's index.
constexpr int kFAlive = 9;
constexpr int kFRegen = 10;
constexpr int kFAttr = 11;
constexpr int kFBlk = 20;
constexpr int kIKb = 0, kIS = 1, kIB = 2, kIIdx = 3, kIMat = 4, kIBlk = 5;
// f32 residual planes of variant V.
template <int V>
constexpr int kNumF = V != kHard ? kFBlk + 4 : kFBlk;
// The recording forward's counters (u64): 0 the next lane to fetch, 1
// thread-iterations (32 per loop trip of a warp), 2 the grid's blocks.
constexpr int kCntNext = 0, kCntThreadIters = 1, kCntBlocks = 2;

struct Consts {
  float sky[6], pl[7], cam[19];
  SoftK soft;
};

// consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32,
// soft constants 32:36 (SoftK; zeros when hard).
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
  k.soft.fresnel = src[35];
}

__device__ __forceinline__ uint32_t lane_pixel(const int* __restrict__ ids,
                                               int n_pix, int n_lanes, int kb,
                                               int lane) {
  long long pos = static_cast<long long>(kb) * n_lanes + lane;
  if (pos > n_pix - 1) pos = n_pix - 1;  // overflow positions repeat the last
  return static_cast<uint32_t>(ids[pos]);
}

// What a launch of regen_idx_kernel / regen_kernel reads and writes
// (spt_regen_forward's arguments; the kernels take them one by one).
struct RegenArgs {
  const int* pixel_ids;
  int n_pix, n_lanes, n_banks;
  const float* tab;
  int n_spheres;
  const float* consts;
  int use_plane;
  uint32_t k0, k1, sample_offset;
  int n_samples, max_depth, width;
  float inv_w, inv_h, t_min, t_max;
  int rr_start_depth, n_iter;
  const float* soft_tab;
  const int* idx_in;
  float* out_rad;
  float* out_cnt;
  float* resf;
  int* resi;
  int* packed;
  unsigned long long* counters;
};

// One lane's walk between iterations.
struct LaneState {
  int kb, s, b, it;
  int prev;  // soft: the chain's previous sphere winner
  int word, bword;
  bool alive;
  uint32_t pix;
  float o[3], d[3], tp[3], acc[3];
};

__device__ __forceinline__ void lane_start(LaneState& w) {
  w.kb = w.s = w.b = w.it = 0;
  w.prev = -1;
  w.word = w.bword = 0;
  w.alive = false;
  w.pix = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.o[c] = 0.0f;
    w.d[c] = c == 2 ? 1.0f : 0.0f;
    w.tp[c] = 1.0f;
    w.acc[c] = 0.0f;
  }
}

// Whether the lane's walk is over: its budget is spent, or its last bank's
// last sample ended.
__device__ __forceinline__ bool lane_done(const RegenArgs& a,
                                          const LaneState& w) {
  return w.it >= a.n_iter || (!w.alive && w.kb >= a.n_banks);
}

// Shared-memory tables of a block: the spheres and the soft scan's.
struct BlockTables {
  SphereTables tabs;
  const float4* soft;
};

template <int V>
__device__ __forceinline__ BlockTables load_block(const RegenArgs& a,
                                                  float4* smem) {
  BlockTables t;
  t.tabs = load_sphere_tables(smem, a.tab, a.n_spheres);
  t.soft = nullptr;
  if constexpr (V != kHard) {
    // After geo, att (n float4 each) and att2 (n float2; n is a multiple
    // of 4).
    t.soft = load_soft_table(smem + 2 * a.n_spheres + a.n_spheres / 2,
                             a.soft_tab, a.n_spheres);
  }
  return t;
}

// The forward kernels' parameters, restrict-qualified so the compiler knows
// that the planes they write alias nothing they read (the same pointers as
// fields of one struct parameter lose that: the full-residual forward ran
// 10% slower on an H100), and the RegenArgs each kernel builds from them.
#define SPT_REGEN_PARAMS                                                      \
  const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,     \
      const float* __restrict__ tab, int n_spheres,                           \
      const float* __restrict__ consts, int use_plane, uint32_t k0,           \
      uint32_t k1, uint32_t sample_offset, int n_samples, int max_depth,      \
      int width, float inv_w, float inv_h, float t_min, float t_max,          \
      int rr_start_depth, int n_iter, const float* __restrict__ soft_tab,     \
      const int* __restrict__ idx_in, float* __restrict__ out_rad,            \
      float* __restrict__ out_cnt, float* __restrict__ resf,                  \
      int* __restrict__ resi, int* __restrict__ packed,                       \
      unsigned long long* __restrict__ counters
#define SPT_REGEN_FIELDS                                                      \
  pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts, use_plane, k0,  \
      k1, sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min,    \
      t_max, rr_start_depth, n_iter, soft_tab, idx_in, out_rad, out_cnt,      \
      resf, resi, packed, counters

// Iteration w.it of lane ``lane`` (whose walk is not over): one bounce,
// regenerating a camera ray first if no path is in flight, with its
// records; then w.it + 1.  Returns the winner code and (soft) the blocker
// index (else -1), whose planes, as alive's, the caller stores.
template <int MODE, int V>
__device__ __forceinline__ int2 regen_step(const RegenArgs& a,
                                           const BlockTables& bt_,
                                           const Consts& k, int lane,
                                           LaneState& w) {
  constexpr bool kSoftV = V != kHard;
  const SphereTables& tabs = bt_.tabs;
  const size_t L = static_cast<size_t>(a.n_lanes);
  const size_t plane_stride = static_cast<size_t>(a.n_iter) * L;
  // Packed words: winners, then (soft) blockers, [n_iter / 3, n_lanes] each.
  const size_t word_stride = static_cast<size_t>(a.n_iter / 3) * L;
  const int it = w.it;
  auto fp = [&](int plane) -> float& {
    return a.resf[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ip = [&](int plane) -> int& {
    return a.resi[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = a.rr_start_depth != 0;
  const bool regen = !w.alive;
  const uint32_t c1b = (a.sample_offset + static_cast<uint32_t>(w.s)) << 8;
  if (regen) {
    // Next sample (or the next bank's pixel): a fresh camera ray.
    w.pix = lane_pixel(a.pixel_ids, a.n_pix, a.n_lanes, w.kb, lane);
    const float xf = static_cast<float>(w.pix % static_cast<uint32_t>(a.width));
    const float yf = static_cast<float>(w.pix / static_cast<uint32_t>(a.width));
    camera_ray(k.cam, a.k0, a.k1, w.pix, c1b, xf, yf, a.inv_w, a.inv_h,
               w.o[0], w.o[1], w.o[2], w.d[0], w.d[1], w.d[2]);
    w.tp[0] = w.tp[1] = w.tp[2] = 1.0f;
    w.b = 0;
    w.prev = -1;
    w.alive = true;
  }
  if (MODE != kModeIdx) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fp(c) = w.o[c];
      fp(3 + c) = w.d[c];
      fp(6 + c) = w.tp[c];
    }
    fp(kFRegen) = regen ? 1.0f : 0.0f;
    ip(kIKb) = w.kb;
    ip(kIS) = w.s;
    ip(kIB) = w.b;
  }
  Bounce f;
  // Soft: the acceptance coin u[7] is read by the scan.
  if constexpr (kSoftV)
    bounce_uniforms(a.k0, a.k1, w.pix, c1b, static_cast<uint32_t>(w.b), f.u);
  const int field = it % 3;
  int bi, qi = -1;
  if (MODE == kModeRefwd) {
    // The recorded winner (and blocker) instead of the scan.
    const size_t wp = static_cast<size_t>(it / 3) * L + lane;
    if (field == 0) {
      w.word = a.idx_in[wp];
      if constexpr (kSoftV) w.bword = a.idx_in[word_stride + wp];
    }
    bi = ((w.word >> (kIdxBits * field)) & kIdxMask) - 1;
    if constexpr (kSoftV) qi = ((w.bword >> (kIdxBits * field)) & kIdxMask) - 1;
  } else if constexpr (kSoftV) {
    // Acceptance coin u[7]; crossing (ux) and validity (uv) coins in
    // slot 128 + b.
    float ux, uv;
    uniforms(a.k0, a.k1, w.pix, c1b | (128u + static_cast<uint32_t>(w.b)), ux,
             uv);
    float bt;
    closest_hit_soft(tabs.geo, bt_.soft, a.n_spheres, w.o[0], w.o[1], w.o[2],
                     w.d[0], w.d[1], w.d[2], a.t_min, a.t_max,
                     silhouette_logit(f.u[7]), silhouette_logit(uv), w.prev,
                     bt, bi, qi);
    if constexpr (V == kSoftPlane) {
      // Plane-vs-sphere crossing coin: the sphere beats the plane iff
      // t_s < t_p + logit(ux) * sigma_x(r_s); a plane win over a sphere
      // less than 30 sigma_x behind stashes that sphere as the blocker.
      const float denom =
          w.d[0] * k.pl[0] + w.d[1] * k.pl[1] + w.d[2] * k.pl[2];
      const float num = -(w.o[0] * k.pl[0] + w.o[1] * k.pl[1] +
                          w.o[2] * k.pl[2] + k.pl[3]);
      const bool live = fabsf(denom) > 1e-8f;
      const float tpl = num / (live ? denom : 1.0f);
      const float pre_r = bi >= 0 ? tabs.geo[bi].w : 1.0f;
      const float sigx = crossing_scale(pre_r, k.soft);
      const float thr_x = silhouette_logit(ux) * sigx;
      const bool wins = live && tpl > a.t_min && tpl < a.t_max &&
                        !(bi >= 0 && bt < tpl + thr_x);
      const bool steal = wins && bi >= 0 && bt - tpl < 30.0f * sigx;
      if (steal) qi = bi;
      if (wins) bi = steal ? kPlaneCrossIdx : kPlaneIdx;
    }
  } else {
    float bt = a.t_max;
    bi = closest_hit(tabs.geo, a.n_spheres, w.o[0], w.o[1], w.o[2], w.d[0],
                     w.d[1], w.d[2], a.t_min, bt);
    float tpl, sgn;
    if (a.use_plane && plane_wins(k.pl, w.o[0], w.o[1], w.o[2], w.d[0],
                                  w.d[1], w.d[2], a.t_min, bt, tpl, sgn))
      bi = kPlaneIdx;
  }
  float wa[9];
  winner_attrs(tabs, k.pl, bi, wa, f.mat);
  float blk[4];
  if constexpr (kSoftV) blocker_attrs(tabs, qi, blk);
  if (MODE == kModeIdx) {
    const int v = bi + 1;
    w.word = field == 0 ? v : w.word + v * (1 << (kIdxBits * field));
    if constexpr (kSoftV) {
      const int bv = qi + 1;
      w.bword = field == 0 ? bv : w.bword + bv * (1 << (kIdxBits * field));
    }
    if (field == 2) {
      const size_t wpos = static_cast<size_t>(it / 3) * L + lane;
      a.packed[wpos] = w.word;
      if constexpr (kSoftV) a.packed[word_stride + wpos] = w.bword;
    }
  } else {
    ip(kIMat) = f.mat;
#pragma unroll
    for (int j = 0; j < 9; ++j) fp(kFAttr + j) = wa[j];
    if constexpr (kSoftV) {
#pragma unroll
      for (int j = 0; j < 4; ++j) fp(kFBlk + j) = blk[j];
    }
  }

  // The bounce (soft: its values; the detached ratio is 1).
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.o[c] = w.o[c];
    f.d[c] = w.d[c];
    f.tp[c] = w.tp[c];
    f.c[c] = wa[c];
    f.alb[c] = wa[4 + c];
  }
  f.r = wa[3];
  f.fz = wa[7];
  f.io = wa[8];
  f.hit = bi >= 0;
  if constexpr (kSoftV) {
    f.pm = V == kSoftPlane && is_plane_code(bi);
  } else {
    f.pm = a.use_plane && bi == kPlaneIdx;
  }
  f.do_rr = w.b >= a.rr_start_depth;
  if constexpr (!kSoftV)
    bounce_uniforms(a.k0, a.k1, w.pix, c1b, static_cast<uint32_t>(w.b), f.u);
  bounce_forward<V>(f, k.sky, a.t_min, a.t_max, rr_on, k.soft.sil_c);
  const bool surv = f.surv && w.b + 1 < a.max_depth;
  if (!f.hit) {
#pragma unroll
    for (int c = 0; c < 3; ++c) w.acc[c] = w.acc[c] + f.rad[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.o[c] = f.no[c];
    w.d[c] = f.nd[c];
    w.tp[c] = f.ntp[c];
  }
  if constexpr (kSoftV) w.prev = f.hit && !f.pm ? bi : -1;
  if (surv) {
    ++w.b;
  } else if (++w.s >= a.n_samples) {
    // The bank's last sample ended: its pixel's sum is complete.
    const long long pos = static_cast<long long>(w.kb) * a.n_lanes + lane;
    if (MODE != kModeRefwd && pos < a.n_pix) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a.out_rad[3 * pos + c] = w.acc[c];
    }
    w.acc[0] = w.acc[1] = w.acc[2] = 0.0f;
    w.s = 0;
    ++w.kb;
  }
  w.alive = surv;
  w.it = it + 1;
  return make_int2(bi, qi);
}

// The idx-only recording forward on a resident grid whose threads fetch
// lanes: a thread whose lane's walk is over writes the lane's count and its
// last, partly filled words, and takes the next lane index from
// counters[kCntNext], one atomicAdd per warp for the threads that need one,
// inside the same loop, so no thread of a warp waits for another's lane to
// end.  A lane's records are those of the fixed map; its words after the
// walk's end are not written here: the wrapper zeroes them first.
template <int V>
__global__ void __launch_bounds__(kThreads, kRegenBlocksPerSm)
    regen_idx_kernel(SPT_REGEN_PARAMS) {
  const RegenArgs a = {SPT_REGEN_FIELDS};
  extern __shared__ float4 smem[];
  // The constants in shared memory: registers are this kernel's limit.
  __shared__ Consts k;
  const BlockTables bt = load_block<V>(a, smem);
  if (threadIdx.x == 0) load_consts(consts, k);
  __syncthreads();
  const size_t L = static_cast<size_t>(a.n_lanes);
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  int lane = 0;
  bool has_lane = false;  // lane's walk is in progress
  bool done = false;      // no lane left for the thread
  unsigned long long trips = 0;
  LaneState w;
  for (;;) {
    if (has_lane && lane_done(a, w)) {
      a.out_cnt[lane] = static_cast<float>(w.it);
      if (w.it % 3 != 0) {
        const size_t wpos = static_cast<size_t>(w.it / 3) * L + lane;
        a.packed[wpos] = w.word;
        if constexpr (V != kHard)
          a.packed[static_cast<size_t>(a.n_iter / 3) * L + wpos] = w.bword;
      }
      has_lane = false;
    }
    const bool fetch = !done && !has_lane;
    const unsigned m = __ballot_sync(kFullWarp, fetch);
    if (m != 0u) {
      const int leader = __ffs(m) - 1;
      unsigned long long base = 0;
      if (wl == leader)
        base = atomicAdd(a.counters + kCntNext,
                         static_cast<unsigned long long>(__popc(m)));
      base = __shfl_sync(kFullWarp, base, leader);
      if (fetch) {
        const unsigned long long next = base + __popc(m & below);
        has_lane = next < static_cast<unsigned long long>(a.n_lanes);
        done = !has_lane;
        if (has_lane) {
          lane = static_cast<int>(next);
          lane_start(w);
        }
      }
    }
    if (__all_sync(kFullWarp, done)) break;
    ++trips;
    if (has_lane) regen_step<kModeIdx, V>(a, bt, k, lane, w);
  }
  if (wl == 0) atomicAdd(a.counters + kCntThreadIters, 32ull * trips);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.counters[kCntBlocks] = gridDim.x;
}

// The full-residual forward and the re-forward (MODE kModeFull or
// kModeRefwd): one thread per lane, so the 25-30 plane stores of an
// iteration coalesce.  Each warp walks its iterations in step, 0 ..
// n_iter - 1: at iteration it a lane below its count runs regen_step, and
// a lane at or above it is dead there, so the alive and idx (soft: bidx)
// planes take every lane's entry of row it, live (1, its winner) or dead
// (0, -1), in the same store instructions, and a dead lane writes zeros
// into the row's other planes, so that no 32-byte sector of the row is
// left partly written (on an H100 that made the hard re-forward ~10%
// faster, though it stores more bytes).  From the warp's longest count on,
// its rows are dead for every lane: the three planes' stores alone, 32
// lanes of one row each, and nothing in the other planes.  (Lanes writing
// their own dead iterations from their own counts would touch up to 32
// rows per store, one word in each 32-byte sector: on the cover chunks
// that cost the hard re-forward ~1.5 ms of its 6.)
template <int MODE, int V>
__global__ void __launch_bounds__(kThreads, kPlaneBlocksPerSm<MODE>)
    regen_kernel(SPT_REGEN_PARAMS) {
  const RegenArgs a = {SPT_REGEN_FIELDS};
  extern __shared__ float4 smem[];
  const BlockTables bt = load_block<V>(a, smem);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < n_lanes;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  float* const alive_p = resf + kFAlive * plane_stride + lane;
  int* const idx_p = resi + kIIdx * plane_stride + lane;
  int* const bidx_p = resi + kIBlk * plane_stride + lane;
  LaneState w;
  lane_start(w);
  int it = 0;
  for (; it < n_iter; ++it) {
    const bool live = in && !lane_done(a, w);
    if (!__any_sync(kFullWarp, live)) break;
    int2 code = make_int2(-1, -1);
    if (live) {
      code = regen_step<MODE, V>(a, bt, k, lane, w);
    } else if (in) {
      const size_t e = static_cast<size_t>(it) * L + lane;
#pragma unroll
      for (int j = 0; j < kNumF<V>; ++j)
        if (j != kFAlive) resf[j * plane_stride + e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kIBlk; ++j)
        if (j != kIIdx) resi[j * plane_stride + e] = 0;
    }
    if (in) {
      const size_t e = static_cast<size_t>(it) * L;
      alive_p[e] = live ? 1.0f : 0.0f;
      idx_p[e] = code.x;
      if constexpr (V != kHard) bidx_p[e] = code.y;
    }
  }
  if (!in) return;
  if (MODE != kModeRefwd) out_cnt[lane] = static_cast<float>(w.it);
  for (; it < n_iter; ++it) {
    const size_t e = static_cast<size_t>(it) * L;
    alive_p[e] = 0.0f;
    idx_p[e] = -1;
    if constexpr (V != kHard) bidx_p[e] = -1;
  }
}

// The backward's staged inputs of one live iteration, per thread: every
// f32 residual plane but alive (a lane is live below its count), in plane
// order, then the int planes kb s b idx mat (soft: bidx).
template <int V>
struct BwdSlots {
  static constexpr int kF = kNumF<V> - 1;
  static constexpr int kI = V != kHard ? kIBlk + 1 : kIBlk;
  static constexpr int kAll = kF + kI;
  // The float slot of residual plane p (p != kFAlive), and the plane of
  // float slot j.
  __host__ __device__ static constexpr int slot(int p) {
    return p < kFAlive ? p : p - 1;
  }
  __host__ __device__ static constexpr int plane(int j) {
    return j < kFAlive ? j : j + 1;
  }
};

// Shared memory of a backward launch: two stages of every thread's slots.
template <int V>
constexpr size_t bwd_smem() {
  return 2 * static_cast<size_t>(BwdSlots<V>::kAll) * kThreads * sizeof(float);
}

// One thread per lane: lane l's iterations run in order on one thread, so
// each plane access of a warp is 32 consecutive words.  A lane's live
// iterations are 0 .. count - 1 (every recording forward and re-forward
// writes alive so); the thread finds count by a binary search over its
// alive column, and the warp walks back only from its lanes' largest count
// (span).  Iterations span .. n_iter - 1 are dead for the whole warp: their
// cotangents are stored as zeros with nothing read.  Inside the span a
// lane's inputs of iteration it - 1 are copied into shared memory
// (cp.async, two stages) while iteration it computes, so the loads' latency
// hides behind the adjoint's arithmetic; a lane above its count computes
// nothing and stores its zeros in the same store instructions as the live
// lanes' cotangents.  The radiance cotangent and pixel are loaded again
// only when the lane's bank changes.  Launch bounds: 4 blocks per SM hard
// (128 registers, 40 B of spill), 3 soft (159, none) and soft + plane
// (168, 124 B of spill; uncapped it took 203 and ran at 2 blocks, 1.4x as
// long on an H100).
template <int V>
__global__ void __launch_bounds__(kThreads, V == kHard ? 4 : 3) regen_bwd_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, const float* __restrict__ resf,
    const int* __restrict__ resi, const float* __restrict__ ct_rad,
    float* __restrict__ ct_planes, float* __restrict__ partials) {
  constexpr bool kSoftV = V != kHard;
  using Slots = BwdSlots<V>;
  extern __shared__ float stage[];  // [2][Slots::kAll][kThreads]
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < n_lanes;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  auto ct = [&](int j, int it) -> float& {
    return ct_planes[j * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = rr_start_depth != 0;
  const bool plane_on = V == kSoftPlane || (V == kHard && use_plane);
  constexpr int kCt = kSoftV ? 13 : 9;

  // The lane's count: the first dead iteration of its alive column.
  int count = 0;
  for (int hi = in ? n_iter : 0; count < hi;) {
    const int mid = (count + hi) >> 1;
    if (resf[kFAlive * plane_stride + static_cast<size_t>(mid) * L + lane] > 0.0f)
      count = mid + 1;
    else
      hi = mid;
  }
  const int span = __reduce_max_sync(kFullWarp, count);
  if (in) {
    for (int it = span; it < n_iter; ++it) {
#pragma unroll
      for (int j = 0; j < kCt; ++j) ct(j, it) = 0.0f;
    }
  }

  float* const mine = stage + threadIdx.x;
  // Copy iteration it's slots into stage it & 1.
  auto fetch = [&](int it) {
    float* dst = mine + (it & 1) * Slots::kAll * kThreads;
    const size_t e = static_cast<size_t>(it) * L + lane;
#pragma unroll
    for (int j = 0; j < Slots::kF; ++j)
      __pipeline_memcpy_async(dst + j * kThreads,
                              resf + Slots::plane(j) * plane_stride + e, 4);
#pragma unroll
    for (int j = 0; j < Slots::kI; ++j)
      __pipeline_memcpy_async(dst + (Slots::kF + j) * kThreads,
                              resi + j * plane_stride + e, 4);
  };
  if (span > 0 && span - 1 < count) fetch(span - 1);
  __pipeline_commit();

  float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f};
  float ctp[3] = {0.0f, 0.0f, 0.0f};
  float sky_part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float pl_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int kb_seen = -1;  // the bank whose pixel and radiance cotangent are held
  uint32_t pix = 0;
  float ctr[3] = {0.0f, 0.0f, 0.0f};
  for (int it = span - 1; it >= 0; --it) {
    if (it > 0 && it - 1 < count) fetch(it - 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // iteration it's copies have landed
    const float* sv = mine + (it & 1) * Slots::kAll * kThreads;
    // The staged values of f32 residual plane p and i32 plane j.
    auto plane_f = [&](int p) -> float {
      return sv[Slots::slot(p) * kThreads];
    };
    auto slot_i = [&](int j) -> int {
      return __float_as_int(sv[(Slots::kF + j) * kThreads]);
    };
    float g_ct[kCt];
#pragma unroll
    for (int j = 0; j < kCt; ++j) g_ct[j] = 0.0f;
    if (it < count) {
      Bounce f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f.o[c] = plane_f(c);
        f.d[c] = plane_f(3 + c);
        f.tp[c] = plane_f(6 + c);
        f.c[c] = plane_f(kFAttr + c);
        f.alb[c] = plane_f(kFAttr + 4 + c);
      }
      f.r = plane_f(kFAttr + 3);
      f.fz = plane_f(kFAttr + 7);
      f.io = plane_f(kFAttr + 8);
      const int kb = slot_i(kIKb), s = slot_i(kIS), b = slot_i(kIB);
      const int idx = slot_i(kIIdx);
      f.mat = slot_i(kIMat);
      f.hit = idx >= 0;
      f.pm = plane_on && is_plane_code(idx);
      f.do_rr = b >= rr_start_depth;
      if (kb != kb_seen) {
        // The lane's bank: its pixel (for the uniforms) and radiance
        // cotangent.
        kb_seen = kb;
        pix = lane_pixel(pixel_ids, n_pix, n_lanes, kb, lane);
        const long long pos = static_cast<long long>(kb) * n_lanes + lane;
#pragma unroll
        for (int c = 0; c < 3; ++c) ctr[c] = pos < n_pix ? ct_rad[3 * pos + c] : 0.0f;
      }
      const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
      bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
      bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
      Soft sf;
      SoftCt sa;
      if constexpr (kSoftV) {
        // The blocker and its role (recorded by the forward).
        sf.bval = slot_i(kIBlk) >= 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) sf.bc[c] = plane_f(kFBlk + c);
        sf.br = plane_f(kFBlk + 3);
        soft_forward<V>(f, sf, k.soft, idx == kPlaneCrossIdx, k.pl, t_min,
                        t_max);
      }
      float g_o[3], g_d[3], g_tp[3], g_a9[9], g_sky[6];
      bounce_adjoint<V>(f, rr_on, co, cd, ctp, ctr, g_o, g_d, g_tp, g_a9,
                        g_sky, sf, k.soft, k.pl, t_min, sa);
#pragma unroll
      for (int j = 0; j < 9; ++j) g_ct[j] = f.hit ? g_a9[j] : 0.0f;
      if constexpr (kSoftV) {
#pragma unroll
        for (int j = 0; j < 4; ++j) g_ct[9 + j] = sf.bval ? sa.blk4[j] : 0.0f;
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
      const bool regen = plane_f(kFRegen) > 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        co[c] = regen ? 0.0f : g_o[c];
        cd[c] = regen ? 0.0f : g_d[c];
        ctp[c] = regen ? 0.0f : g_tp[c];
      }
    }
    if (in) {
#pragma unroll
      for (int j = 0; j < kCt; ++j) ct(j, it) = g_ct[j];
    }
  }
  if (!in) return;
#pragma unroll
  for (int c = 0; c < 6; ++c) partials[c * L + lane] = sky_part[c];
#pragma unroll
  for (int j = 0; j < 4; ++j) partials[(6 + j) * L + lane] = pl_part[j];
}

// Shared memory of a forward launch: the sphere tables (soft: and the soft
// scan's table).
template <int V>
size_t regen_smem(int n_spheres) {
  return static_cast<size_t>(n_spheres) *
         (kSmemPerSphere + (V != kHard ? sizeof(float4) : 0));
}

// Launch a forward kernel with a's fields as its parameters.
template <typename Kernel>
void launch_fields(Kernel kernel, int blocks, size_t smem, cudaStream_t stream,
                   const RegenArgs& a) {
  kernel<<<blocks, kThreads, smem, stream>>>(
      a.pixel_ids, a.n_pix, a.n_lanes, a.n_banks, a.tab, a.n_spheres,
      a.consts, a.use_plane, a.k0, a.k1, a.sample_offset, a.n_samples,
      a.max_depth, a.width, a.inv_w, a.inv_h, a.t_min, a.t_max,
      a.rr_start_depth, a.n_iter, a.soft_tab, a.idx_in, a.out_rad, a.out_cnt,
      a.resf, a.resi, a.packed, a.counters);
}

template <int MODE, int V>
cudaError_t launch_regen(const RegenArgs& a, cudaStream_t stream) {
  const size_t smem = regen_smem<V>(a.n_spheres);
  if constexpr (MODE == kModeIdx) {
    int blocks = 0;
    cudaError_t err = allow_smem(regen_idx_kernel<V>, smem);
    if (err == cudaSuccess)
      err = grid_for(regen_idx_kernel<V>, kThreads, a.n_lanes, smem, blocks);
    if (err != cudaSuccess) return err;
    launch_fields(regen_idx_kernel<V>, blocks, smem, stream, a);
  } else {
    const cudaError_t err = allow_smem(regen_kernel<MODE, V>, smem);
    if (err != cudaSuccess) return err;
    launch_fields(regen_kernel<MODE, V>, (a.n_lanes + kThreads - 1) / kThreads,
                  smem, stream, a);
  }
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_regen_variant(int variant, const RegenArgs& a,
                                 cudaStream_t stream) {
  switch (variant) {
    case kHard: return launch_regen<MODE, kHard>(a, stream);
    case kSoft: return launch_regen<MODE, kSoft>(a, stream);
    case kSoftPlane: return launch_regen<MODE, kSoftPlane>(a, stream);
    default: return cudaErrorInvalidValue;
  }
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
// [n_spheres, 4] table).  Mode 1 fetches lanes: counters is u64[3],
// zeroed by the caller (the next lane; then the kernel adds its
// thread-iterations and writes its grid's blocks), and it writes no word
// after a lane's end (the caller zeroes the words first).
// Returns cudaGetLastError() (0 = launched).
extern "C" int spt_regen_forward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, int n_iter, int mode,
    float softness, const void* soft_tab, const void* idx_in, void* out_rad,
    void* out_cnt, void* resf, void* resi, void* packed, void* counters,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = spt::variant_of(softness, use_plane);
  const spt::RegenArgs a = {
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max,
      rr_start_depth, n_iter, static_cast<const float*>(soft_tab),
      static_cast<const int*>(idx_in), static_cast<float*>(out_rad),
      static_cast<float*>(out_cnt), static_cast<float*>(resf),
      static_cast<int*>(resi), static_cast<int*>(packed),
      static_cast<unsigned long long*>(counters)};
  cudaError_t err;
  switch (mode) {
    case spt::kModeFull: err = spt::launch_regen_variant<spt::kModeFull>(variant, a, st); break;
    case spt::kModeIdx: err = spt::launch_regen_variant<spt::kModeIdx>(variant, a, st); break;
    case spt::kModeRefwd: err = spt::launch_regen_variant<spt::kModeRefwd>(variant, a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
      spt::regen_bwd_kernel<spt::kHard>
          <<<blocks, spt::kThreads, spt::bwd_smem<spt::kHard>(), st>>>(SPT_ARGS);
      break;
    case spt::kSoft:
      spt::regen_bwd_kernel<spt::kSoft>
          <<<blocks, spt::kThreads, spt::bwd_smem<spt::kSoft>(), st>>>(SPT_ARGS);
      break;
    default:
      spt::regen_bwd_kernel<spt::kSoftPlane>
          <<<blocks, spt::kThreads, spt::bwd_smem<spt::kSoftPlane>(), st>>>(SPT_ARGS);
      break;
  }
#undef SPT_ARGS
  return static_cast<int>(cudaGetLastError());
}
