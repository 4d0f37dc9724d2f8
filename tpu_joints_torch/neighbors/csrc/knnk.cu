// Kernel K2: exact 3-D k nearest valid source points for every query row,
// 2 <= k <= 32.
//
// Replaces the TPU kernel tpu_joints/neighbors/pallas_knn.py::_knn_kernel in
// its k>1 mode (entry point knn_pallas). Same distance and masking contract
// (see knn_split.cuh). The TPU kernel leaves its best-list unsorted; this one
// returns it ascending with ties to the lowest source index -- the first k
// of a stable sort of the row, which is what the plain PyTorch version
// (knnk_reference) computes.
//
// What bounds it on the card: ~9 flops and one compare per (query, source)
// pair, plus K compare-selects for each source that beats a lane's K-th
// best; the inputs are a few hundred kB, so it is bound by the instruction
// rate of that loop, not by memory. The previous design (one thread per
// query row) lost to three causes, and knn_split.cuh answers each:
//  * too few warps: 2560 rows made 40 blocks of 2 warps on 40 of 132 SMs.
//    Each row is now split over S lanes of a warp, S as large as still
//    fits the card in one wave (S = 32 at 1024-2560 rows: 2560 warps at
//    2560; S = 4 at 16384 rows, k = 30), and the S sorted lists are merged
//    by k rounds of a lexicographic shuffle arg-min;
//  * a K-step dependent insertion chain paid by nearly every source (the
//    scene's sources arrive in scan order and approach each query
//    monotonically): the insertion is now K independent compare-selects,
//    and each lane walks 1/S of the sources;
//  * masked sources staged and compared one by one (the clustered OBB's
//    16384-lane view is about half masked): they are dropped at staging.
// Blocks of 256 threads and 20.6 kB of shared memory; registers bound the
// occupancy (ptxas, sm_90a: K = 32 uses 100 registers, 2 blocks or 16 warps
// per SM; K = 16 64, 4 blocks or 32 warps; K = 2..8 40-48, 5-6 blocks; no
// spills except 8 bytes at K = 8).
// What is left at the clustered OBB's shape is the insertion as the warp
// sees it: a lane inserts rarely, but the warp's 32 lanes (8 rows) pay the
// K selects whenever any of them inserts, about every other step there.
// Visiting sources out of order, a bound from a first pass near the rows,
// and queueing candidates per lane were tried and not kept (PERF.md).
#include "knn_split.cuh"

// Launches on `stream` (a cudaStream_t passed as void*) and returns the
// launch's cudaError_t: 0 when the kernel was accepted. k outside [2, 32]
// returns cudaErrorInvalidValue without launching.
extern "C" int tj_knnk(const float* query, const float* source,
                       const uint8_t* mask, float* out_d, int* out_i, int M,
                       int N, int k, void* stream) {
  if (k < 2 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using tj::launch_knn;
  if (k <= 2) return launch_knn<2>(query, source, mask, out_d, out_i, 1, M, N, k, s);
  if (k <= 4) return launch_knn<4>(query, source, mask, out_d, out_i, 1, M, N, k, s);
  if (k <= 8) return launch_knn<8>(query, source, mask, out_d, out_i, 1, M, N, k, s);
  if (k <= 16)
    return launch_knn<16>(query, source, mask, out_d, out_i, 1, M, N, k, s);
  return launch_knn<32>(query, source, mask, out_d, out_i, 1, M, N, k, s);
}
