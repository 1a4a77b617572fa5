// Bucket accumulation for Hopper (sm_90a): d[s, k] = sum_r [idx_r == s] *
// cols[k, r], over the K cotangent planes the backward kernel writes
// (csrc/grad_regen.cu): K = 9 winner-attribute columns (bucketed by winner
// index), or, under soft silhouettes, K = 4 blocker columns cx cy cz r
// (bucketed by blocker index).
//
// Replaces the TPU kernel ops/pallas_bucket.py:_bucket_kernel of the JAX
// package, which builds one-hot tiles for the TPU's matrix unit (with the
// indices bitcast into the operand and a bf16x3 split of the cotangents,
// and the blocker's 4 columns padded to 9).  On Hopper a scatter-add needs
// neither: each block keeps a [n_buckets, K] f32 accumulator in shared
// memory (488 x 9 x 4 B = 17.6 KB for the cover scene), adds its rows with
// shared-memory atomics, and flushes each nonzero entry with one global
// atomic.  K is a template parameter, so each column count keeps its loop
// unrolled.  Rows with idx < 0 (dead and miss iterations, no blocker) or
// idx >= n_buckets (the ground plane's codes) are skipped.
//
// Bound: bytes.  Every row's index is read (4 B) and the live rows' K
// cotangents (4K B); the table written is a few KB.  The order of the
// atomic adds changes from run to run, so sums agree with the plain
// version (index_add_) to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 per SM of an H100

template <int K>
__global__ void __launch_bounds__(kThreads) bucket_kernel(
    const float* __restrict__ cols, const int* __restrict__ idx,
    long long n_rows, int n_buckets, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int n_acc = n_buckets * K;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n_rows; r += stride) {
    const int s = idx[r];
    if (s < 0 || s >= n_buckets) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = cols[k * n_rows + r];
      if (v != 0.0f) atomicAdd(&acc[s * K + k], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

template <int K>
cudaError_t launch_bucket(const void* cols, const void* idx, long long n_rows,
                          int n_buckets, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_buckets) * K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  bucket_kernel<K><<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(cols), static_cast<const int*>(idx), n_rows,
      n_buckets, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// cols: [n_cols, n_rows] f32, n_cols 9 (winner attributes) or 4 (the
// blocker's); out: [n_buckets, n_cols] f32, zeroed by the caller.  Returns
// cudaGetLastError().
extern "C" int spt_bucket(const void* cols, const void* idx, long long n_rows,
                          int n_cols, int n_buckets, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_cols) {
    case 9: err = launch_bucket<9>(cols, idx, n_rows, n_buckets, out, st); break;
    case 4: err = launch_bucket<4>(cols, idx, n_rows, n_buckets, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
