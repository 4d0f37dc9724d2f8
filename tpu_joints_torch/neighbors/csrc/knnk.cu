// Exact 3-D k nearest valid source points for every query row, 2 <= k <= 32.
//
// Replaces the TPU kernel tpu_joints/neighbors/pallas_knn.py::_knn_kernel in
// its k>1 mode (entry point knn_pallas). Same distance and masking contract:
//   d(q, s) = ((dx*dx + dy*dy) + dz*dz) + pen,  pen = 0 on valid sources and
//   3e38 on masked ones; every slot starts at (3e38, 0) and a source enters
//   only on a strict '<' against the current k-th best, so a masked source
//   never enters and a slot without a valid source keeps (3e38, 0).
// The TPU kernel leaves its best-list unsorted; this one keeps it sorted by
// (distance, source index), so the output is ascending with ties to the
// lowest source index -- the first k of a stable sort of the row, which is
// what the plain PyTorch version (knnk_reference) computes. Built with
// --fmad=false so the sum above is rounded term by term, as the plain
// version computes it op by op.
//
// What bounds it on the card: ~9 flops and one compare per (query, source)
// pair plus an insertion of K compare-selects for the few sources that beat
// the k-th best; the inputs are a few hundred kB, so it is bound by the
// issue rate of that loop, not by memory. Design: one thread per query row
// keeps its sorted list of K (distance, index) pairs in registers (K is a
// template parameter, 2/4/8/16/32, so the fully unrolled insertion indexes
// the list with constants; a call with k < K keeps K and writes the first
// k); the block stages source tiles through shared memory as
// structure-of-arrays x/y/z plus the penalty, so each source is read from
// device memory once per block and broadcast to all its threads. Blocks are
// independent: a loop over source tiles inside the block replaces the TPU's
// sequential source-axis grid dimension.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;
constexpr float kInf = 3.0e38f;

template <int K>
__global__ void __launch_bounds__(kThreads)
knnk_kernel(const float* __restrict__ query, const float* __restrict__ source,
            const uint8_t* __restrict__ mask, float* __restrict__ out_d,
            int* __restrict__ out_i, int M, int N, int k) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ float sp[kTile];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (row < M) {
    qx = query[3 * row + 0];
    qy = query[3 * row + 1];
    qz = query[3 * row + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = kInf;
    bi[j] = 0;
  }

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int j = base + t;
      sx[t] = source[3 * j + 0];
      sy[t] = source[3 * j + 1];
      sz[t] = source[3 * j + 2];
      sp[t] = mask[j] ? 0.0f : kInf;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float dx = qx - sx[t];
      const float dy = qy - sy[t];
      const float dz = qz - sz[t];
      const float d = ((dx * dx + dy * dy) + dz * dz) + sp[t];
      // the new source has the highest index so far: at an equal distance
      // it sorts after every listed entry, so a tie with the k-th best
      // never enters
      if (d < bd[K - 1]) {
        float cd = d;
        int ci = base + t;
        // one pass of compare-and-swap down the sorted list: the carried
        // entry sinks to its place and the old k-th best falls off the end
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const bool swap = cd < bd[j] || (cd == bd[j] && ci < bi[j]);
          const float td = bd[j];
          const int ti = bi[j];
          bd[j] = swap ? cd : td;
          bi[j] = swap ? ci : ti;
          cd = swap ? td : cd;
          ci = swap ? ti : ci;
        }
      }
    }
  }
  if (row < M) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        out_d[row * k + j] = bd[j];
        out_i[row * k + j] = bi[j];
      }
    }
  }
}

template <int K>
int launch(const float* query, const float* source, const uint8_t* mask,
           float* out_d, int* out_i, int M, int N, int k,
           cudaStream_t stream) {
  const int blocks = (M + kThreads - 1) / kThreads;
  knnk_kernel<K><<<blocks, kThreads, 0, stream>>>(query, source, mask, out_d,
                                                  out_i, M, N, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as void*) and returns the
// launch's cudaError_t: 0 when the kernel was accepted. k outside [2, 32]
// returns cudaErrorInvalidValue without launching.
extern "C" int tj_knnk(const float* query, const float* source,
                       const uint8_t* mask, float* out_d, int* out_i, int M,
                       int N, int k, void* stream) {
  if (k < 2 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 2) return launch<2>(query, source, mask, out_d, out_i, M, N, k, s);
  if (k <= 4) return launch<4>(query, source, mask, out_d, out_i, M, N, k, s);
  if (k <= 8) return launch<8>(query, source, mask, out_d, out_i, M, N, k, s);
  if (k <= 16) return launch<16>(query, source, mask, out_d, out_i, M, N, k, s);
  return launch<32>(query, source, mask, out_d, out_i, M, N, k, s);
}
