// Split-row exact 3-D k nearest valid sources, shared by kernels K1 (nn1.cu,
// K = 1) and K2 (knnk.cu, K = 2/4/8/16/32).
//
// Contract (both kernels, and their plain PyTorch versions):
//   d(q, s) = ((dx*dx + dy*dy) + dz*dz) + pen,  pen = 0 on valid sources and
//   3e38 on masked ones; the k smallest per row, ascending, ties to the
//   lowest source index; a slot without a valid source is (3e38, 0).
// A masked source's distance rounds to >= 3e38, so it never passes the
// strict '<' against an empty slot and never enters a list; it is dropped
// when its tile is staged (below), and for a kept source pen = 0 adds
// nothing (x + 0 == x), so the kernel sums ((dx*dx + dy*dy) + dz*dz) only.
// Built with --fmad=false, so every product and sum is rounded on its own,
// as the plain versions compute them op by op.
//
// Layout of the work:
//  * Split. Each query row is served by S lanes of one warp (S a power of
//    two, 1..32: the largest with which all M * S threads are resident on
//    the card at once, see split_for). Lane g of a row visits the staged
//    sources g, g+S, g+2S, ... of every tile: its share, in ascending source
//    index.
//  * Per-lane list. Each lane keeps the K best (distance, index) pairs of
//    its share sorted in registers (K is a template parameter, so every
//    list index is a constant after unrolling). A source enters on a strict
//    '<' against the lane's K-th best; its index exceeds every listed one,
//    so that test is the lexicographic (d, idx) test, and the insertion is
//    K independent compare-selects: slot j takes its left neighbour if the
//    new entry beats slot j-1, else the new entry if it beats slot j, else
//    keeps its value. Nothing is carried from slot to slot.
//  * Merge. k rounds of a lexicographic (d, idx) arg-min of the S lanes'
//    list heads by __shfl_xor_sync over the row's lanes; lane 0 writes the
//    winner, and the lane holding it pops its head (valid indices are
//    unique; empty (3e38, 0) heads tie, but once one wins all that is left
//    is empty). The result is the first k of a stable sort of the row.
//  * Tiles. A block of kThreads threads stages kTile sources at a time in
//    shared memory as one 16-byte word each (x, y, z, source index), so a
//    pair costs one shared load. A ballot per warp and a shuffle scan of
//    the warps' counts drop masked sources and keep each kept source's
//    index in order; the coordinates are then read as contiguous floats of
//    the [N, 3] array (coalesced) and scattered to their compacted slots.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tj {

constexpr int kThreads = 256;                  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                    // sources staged per tile
constexpr int kPasses = kTile / kThreads;      // staging passes per tile
constexpr float kInf = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPasses * kWarps == 32, "one warp scans a tile's ballots");

// Stages sources [base, base + n) into `tile`, valid ones only, in index
// order; returns how many were kept. Every thread of the block calls it.
__device__ __forceinline__ int stage_tile(
    const float* __restrict__ source, const uint8_t* __restrict__ mask,
    int base, int n, float4* tile, int* pos, int* wcount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous tile is no longer read
  bool keep[kPasses];
  int rank[kPasses];
#pragma unroll
  for (int r = 0; r < kPasses; ++r) {
    const int t = r * kThreads + tid;
    keep[r] = t < n && mask[base + t] != 0;
    const unsigned bal = __ballot_sync(kFull, keep[r]);
    rank[r] = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) wcount[r * kWarps + warp] = __popc(bal);
  }
  __syncthreads();
  // inclusive scan of the 32 chunk counts (chunk r * kWarps + w holds
  // sources r * kThreads + 32 w ...), one chunk per lane
  const int cnt = wcount[lane];
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    incl += lane >= off ? v : 0;
  }
  const int excl = incl - cnt;
  const int kept = __shfl_sync(kFull, incl, 31);
#pragma unroll
  for (int r = 0; r < kPasses; ++r) {
    const int t = r * kThreads + tid;
    const int before = __shfl_sync(kFull, excl, r * kWarps + warp);
    const int p = keep[r] ? before + rank[r] : -1;
    if (t < n) pos[t] = p;
    if (p >= 0) tile[p].w = __int_as_float(base + t);
  }
  __syncthreads();
  float* flat = reinterpret_cast<float*>(tile);
  const float* src = source + 3 * static_cast<long long>(base);
  for (int f = tid; f < 3 * n; f += kThreads) {
    const int t = f / 3;
    const int p = pos[t];
    if (p >= 0) flat[4 * p + (f - 3 * t)] = src[f];
  }
  __syncthreads();
  return kept;
}

// One block: kThreads / S query rows; rows past M compute on a dummy query
// (they must still take part in the staging and the shuffles) and write
// nothing. blockIdx.y is the batch entry: entry b searches its own M query
// rows against its own N sources and mask (the arrays are [B, M, 3],
// [B, N, 3], [B, N] and [B, M, k], contiguous), so the staging compacts each
// entry's sources by that entry's mask; an unbatched launch is B = 1.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const float* __restrict__ query,
                 const float* __restrict__ source,
                 const uint8_t* __restrict__ mask, float* __restrict__ out_d,
                 int* __restrict__ out_i, int M, int N, int k, int S) {
  __shared__ float4 tile[kTile];
  __shared__ int pos[kTile];
  __shared__ int wcount[32];

  const long long b = blockIdx.y;
  query += 3 * b * M;
  source += 3 * b * N;
  mask += b * N;
  out_d += b * M * k;
  out_i += b * M * k;
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int row = gid / S;
  const int g = gid & (S - 1);
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
    const int kept = stage_tile(source, mask, base, min(kTile, N - base),
                                tile, pos, wcount);
    for (int t = g; t < kept; t += S) {
      const float4 p = tile[t];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d = (dx * dx + dy * dy) + dz * dz;
      if (d < bd[K - 1]) {
        const int ci = __float_as_int(p.w);
        // from the end down, so each slot reads its left neighbour's old
        // value: K independent selects
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          const bool here = d < bd[j];
          const bool left = d < bd[j - 1];
          bd[j] = left ? bd[j - 1] : (here ? d : bd[j]);
          bi[j] = left ? bi[j - 1] : (here ? ci : bi[j]);
        }
        bi[0] = d < bd[0] ? ci : bi[0];
        bd[0] = d < bd[0] ? d : bd[0];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r >= k) break;
    float md = bd[0];
    int mi = bi[0];
    for (int off = 1; off < S; off <<= 1) {
      const float od = __shfl_xor_sync(kFull, md, off);
      const int oi = __shfl_xor_sync(kFull, mi, off);
      const bool take = od < md || (od == md && oi < mi);
      md = take ? od : md;
      mi = take ? oi : mi;
    }
    if (g == 0 && row < M) {
      out_d[static_cast<long long>(row) * k + r] = md;
      out_i[static_cast<long long>(row) * k + r] = mi;
    }
    if (r + 1 < K) {
      const bool pop = bd[0] == md && bi[0] == mi;
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) {
        bd[j] = pop ? bd[j + 1] : bd[j];
        bi[j] = pop ? bi[j + 1] : bi[j];
      }
      bd[K - 1] = pop ? kInf : bd[K - 1];
      bi[K - 1] = pop ? 0 : bi[K - 1];
    }
  }
}

// Threads of knn_split_kernel<K> the card holds at once: SMs x resident
// blocks (bounded by the K-dependent register count) x kThreads. Read once
// per process, from the device current at the first launch, and used for
// every card after it: right for a mesh of identical cards (H100s), which
// is what a mesh of this process is; a mix of card models would take the
// first one's split.
template <int K>
int resident_threads() {
  static const int n = [] {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_split_kernel<K>,
                                                  kThreads, 0);
    return sms * blocks * kThreads;
  }();
  return n;
}

// Lanes per row: the largest power of two (at most 32) with which all
// `rows` query rows of the launch (B * M) still fit on the card in one wave
// -- more lanes shorten each lane's sweep, a second wave would double the
// time; 1 when the rows alone do not fit.
inline int split_for(long long rows, int resident) {
  int s = 1;
  while (s < 32 && rows * (2 * s) <= resident) s <<= 1;
  return s;
}

// Launches B batch entries (grid.y; at most 65535) on `stream` and returns
// the launch's cudaError_t.
template <int K>
int launch_knn(const float* query, const float* source, const uint8_t* mask,
               float* out_d, int* out_i, int B, int M, int N, int k,
               cudaStream_t stream) {
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int S = split_for(static_cast<long long>(B) * M, resident_threads<K>());
  const long long threads = static_cast<long long>(M) * S;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  knn_split_kernel<K><<<grid, kThreads, 0, stream>>>(
      query, source, mask, out_d, out_i, M, N, k, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tj
