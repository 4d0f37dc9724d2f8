// Kernel K1: exact 3-D nearest valid source point for every query row (k = 1).
//
// Replaces the TPU kernel tpu_joints/neighbors/pallas_knn.py::_knn_kernel in
// its k=1 mode (entry point knn_pallas). Same contract (see knn_split.cuh):
// the running best starts at (3e38, 0) and is replaced only on a strict '<'
// while each lane visits its sources in ascending order, and the lanes'
// bests are merged lexicographically on (distance, index), so ties go to the
// lowest source index and a row with no valid source keeps (3e38, 0) -- an
// index already inside [0, N-1]. Equal bit for bit to the plain PyTorch
// version (nn1_reference).
//
// What bounds it on the card: ~9 flops and one compare per (query, source)
// pair; the main path's shapes (8192 x 2560 for ICP, 40960 x 2048 and
// 10240 x 4096 for scene coverage: 21M-84M pairs) move well under 1 MB, so
// it is bound by the instruction rate of the inner loop, not by memory. It
// is the K = 1 case of knn_split.cuh. One thread per row gave 64 blocks of 4
// warps at 8192 rows, on 64 of 132 SMs; now each row is split over S lanes
// of a warp, S as large as still fits the card in one wave (40 registers, 6
// blocks of 256 threads or 48 warps per SM: S = 16 at 8192 and 10240 rows,
// 4 at 40960), each lane keeps a running best over its share, and one
// shuffle arg-min over the row's lanes gives the answer. Masked sources are
// dropped when a tile is staged, and a tile is read as contiguous floats.
#include "knn_split.cuh"

// Launches on `stream` (a cudaStream_t passed as void*) and returns the
// launch's cudaError_t: 0 when the kernel was accepted.
extern "C" int tj_nn1(const float* query, const float* source,
                      const uint8_t* mask, float* out_d, int* out_i, int M,
                      int N, void* stream) {
  if (M <= 0) return 0;
  return tj::launch_knn<1>(query, source, mask, out_d, out_i, 1, M, N, 1,
                           static_cast<cudaStream_t>(stream));
}

// K1's batch mode: what the TPU kernel computes under jax.vmap, where the
// batch becomes an outer grid axis. Entry b of query f32[B, M, 3] searches
// entry b of source f32[B, N, 3] under mask u8[B, N]; out_d f32[B, M] and
// out_i i32[B, M] (indices within the entry). One launch, the batch on
// grid.y; the lanes per row are chosen from all B * M resident rows, so a
// batch that fills the card alone (48 x 8192 rows) runs at S = 1-2 where one
// entry of it would run at S = 16. Each entry's result equals tj_nn1 on that
// entry bit for bit: a lane count only changes which lane visits a source,
// and the merge is the same lexicographic arg-min.
extern "C" int tj_nn1_batched(const float* query, const float* source,
                              const uint8_t* mask, float* out_d, int* out_i,
                              int B, int M, int N, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  return tj::launch_knn<1>(query, source, mask, out_d, out_i, B, M, N, 1,
                           static_cast<cudaStream_t>(stream));
}
