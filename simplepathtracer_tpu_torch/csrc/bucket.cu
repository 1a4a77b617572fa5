// Bucket accumulation for Hopper (sm_90a): d[s, k] = sum_r [idx_r == s] *
// cols[k, r], over the K cotangent planes the backward kernels write
// (csrc/grad_regen.cu, csrc/grad.cu): K = 9 winner-attribute columns
// (bucketed by winner index; on an emissive scene K = 12, the winner's
// emission rgb after them), or, under soft silhouettes, K = 4 blocker
// columns cx cy cz r (bucketed by blocker index).
//
// Replaces the TPU kernel ops/pallas_bucket.py:_bucket_kernel of the JAX
// package, which builds one-hot tiles for the TPU's matrix unit (with the
// indices bitcast into the operand and a bf16x3 split of the cotangents,
// and the blocker's 4 columns padded to 9).  On Hopper a scatter-add needs
// neither: each block keeps a [n_buckets, K] f32 table in shared memory
// (488 x 9 x 4 B = 17.6 KB for the cover scene) and flushes each nonzero
// entry with one global atomic.  K is a template parameter, so each column
// count keeps its loops unrolled.  Rows with idx < 0 (dead and miss
// iterations, no blocker) or idx >= n_buckets (the ground plane's codes)
// are skipped.
//
// Design.  sm_90a has no shared-memory float add: atomicAdd on a shared
// float compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), and lanes of
// one instruction that name the same address retry one after another.  The
// rows are not spread over the table: row it * L + lane of the regen planes
// holds neighbouring pixels in neighbouring lanes, and on the cover scene
// the r = 1000 ground sphere (slot 0) takes 38% of the rows that name a
// sphere, so a warp's 32 rows hold 3.8 distinct keys on average (hard fit
// chunk).  So each warp reduces its rows by key before anything touches
// shared memory: it takes 32 consecutive rows at a time (lane j reads row
// base + j, every load coalesced), __match_any_sync gives each lane the
// lanes that hold its key, their K columns are summed by shuffles in
// log2(lanes) steps, and one lane per distinct key adds the K sums to the
// table, so no two lanes of an add name one address.  Where every live lane
// of the 32 holds one key, a full butterfly of shuffles replaces the match
// and lanes 0 .. K-1 each add one column.  A group with no live row loads
// no column.  Each warp walks runs of kGroups consecutive groups, strided
// over the grid, so the dense early iterations and the sparse late ones
// spread over all warps.  (On an H100 at the hard fit chunk, PERF.md §6:
// 2.65 ms with an atomic per row and column, 1.11 so; keeping a warp's
// sums in registers while one key repeats over
// consecutive groups ran slower, 1.48 ms, since only 5% of groups repeat
// the previous group's single key and the sums cost registers; 512-thread
// blocks, runs of 2, 8 or 32 groups, and issuing the next group's loads
// before this group's sums ran no faster.)
//
// Bound: bytes.  Every row's index is read (4 B) and the live rows' K
// cotangents (4K B); the table written is a few KB.  A load moves whole
// 32-byte sectors, and a sector of a column holding one live row moves 8
// rows' values, which the bound does not count.  The order of the atomic
// adds changes from run to run, so sums agree with the plain version
// (index_add_) to rounding, not bit for bit.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kBucketThreads = 256;
constexpr int kBucketWarps = kBucketThreads / 32;
// Consecutive groups of 32 rows a warp walks before it strides.
constexpr int kGroups = 4;

// Every lane holds the warp's sums of v (a butterfly); lanes 0 .. K-1 each
// add one column to row ``key`` of the table.
template <int K>
__device__ __forceinline__ void add_warp_sums(float (&v)[K], int key,
                                              float* acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFullWarp, v[k], off);
  }
  const int lane = threadIdx.x & 31;
  float mine = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (lane == k) mine = v[k];
  }
  if (lane < K) atomicAdd(&acc[key * K + lane], mine);
}

// The lanes that hold one key sum their v by shuffles: at step i each lane
// whose rank among its key's lanes is a multiple of 2^i adds the sum held
// by the lane 2^i ranks above it, so after log2(lanes) steps the key's
// first lane holds its total, and adds it to the table if ``live``.  Each
// lane's key is unique where it is not live.
template <int K>
__device__ __forceinline__ void add_peer_sums(float (&v)[K], int key,
                                              bool live, float* acc) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullWarp, key);
  // The key's lanes above this one, and this lane's rank among them.
  unsigned above = peers & (0xfffffffeu << lane);
  int rank = __popc(peers & ((1u << lane) - 1u));
  const bool first = rank == 0;
  while (__any_sync(kFullWarp, above != 0u)) {
    const int next = __ffs(above);
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = __shfl_sync(kFullWarp, v[k], src);
      if (next) v[k] += t;
    }
    // Lanes of odd rank have handed their sums down: drop them.
    above &= ~__ballot_sync(kFullWarp, rank & 1);
    rank >>= 1;
  }
  if (live && first) {
#pragma unroll
    for (int k = 0; k < K; ++k) atomicAdd(&acc[key * K + k], v[k]);
  }
}

template <int K>
__global__ void __launch_bounds__(kBucketThreads) bucket_kernel(
    const float* __restrict__ cols, const int* __restrict__ idx,
    long long n_rows, int n_buckets, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int n_acc = n_buckets * K;
  for (int i = threadIdx.x; i < n_acc; i += kBucketThreads) acc[i] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n_groups = (n_rows + 31) >> 5;
  const long long n_runs = (n_groups + kGroups - 1) / kGroups;
  const long long n_warps = static_cast<long long>(gridDim.x) * kBucketWarps;
  for (long long run = static_cast<long long>(blockIdx.x) * kBucketWarps +
                       (threadIdx.x >> 5);
       run < n_runs; run += n_warps) {
    long long g = run * kGroups;
    const long long g_end = g + kGroups < n_groups ? g + kGroups : n_groups;
    long long r = (g << 5) + lane;
    // The next group's index is loaded while this group is summed.
    int next = r < n_rows ? idx[r] : -1;
    for (; g < g_end; ++g, r += 32) {
      const int key = next;
      if (g + 1 < g_end) next = r + 32 < n_rows ? idx[r + 32] : -1;
      const bool live = key >= 0 && key < n_buckets;
      const unsigned live_lanes = __ballot_sync(kFullWarp, live);
      if (live_lanes == 0u) continue;
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = live ? cols[k * n_rows + r] : 0.0f;
      const int lead = __shfl_sync(kFullWarp, key, __ffs(live_lanes) - 1);
      if (__all_sync(kFullWarp, !live || key == lead))
        add_warp_sums<K>(v, lead, acc);
      else
        add_peer_sums<K>(v, live ? key : -1 - lane, live, acc);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += kBucketThreads) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

template <int K>
cudaError_t launch_bucket(const void* cols, const void* idx, long long n_rows,
                          int n_buckets, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_buckets) * K * sizeof(float);
  // As many blocks as the card keeps resident, or one warp per run of
  // groups where that is fewer (grid_for counts 32 threads per run).
  const long long n_runs = ((n_rows + 31) / 32 + kGroups - 1) / kGroups;
  int blocks = 0;
  cudaError_t err = allow_smem(bucket_kernel<K>, smem);
  if (err == cudaSuccess)
    err = grid_for(bucket_kernel<K>, kBucketThreads, n_runs * 32, smem, blocks);
  if (err != cudaSuccess) return err;
  bucket_kernel<K><<<blocks, kBucketThreads, smem, stream>>>(
      static_cast<const float*>(cols), static_cast<const int*>(idx), n_rows,
      n_buckets, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spt

// cols: [n_cols, n_rows] f32, n_cols 9 (winner attributes), 12 (and the
// winner's emission) or 4 (the blocker's); out: [n_buckets, n_cols] f32,
// zeroed by the caller.  Returns cudaGetLastError().
extern "C" int spt_bucket(const void* cols, const void* idx, long long n_rows,
                          int n_cols, int n_buckets, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_cols) {
    case 9:
      err = spt::launch_bucket<9>(cols, idx, n_rows, n_buckets, out, st);
      break;
    case 4:
      err = spt::launch_bucket<4>(cols, idx, n_rows, n_buckets, out, st);
      break;
    case 12:
      err = spt::launch_bucket<12>(cols, idx, n_rows, n_buckets, out, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
