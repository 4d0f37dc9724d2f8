// Kernel hv_greedy: GO-HV's single-flip greedy search, one CUDA block a frame.
//
// Replaces no TPU kernel: the JAX package leaves this search to XLA
// (tpu_joints/recognize/hv.py::_greedy_verify, a lax.fori_loop of batched
// [H, Ns] products). The port ran it as PyTorch operations: 2H dependent
// steps of ~33 small ATen kernels each (~2,300 launches a frame at H = 48),
// ~5.5 ms of the card a frame in joint_hv.cams2 for well under a millisecond
// of work. This kernel runs the 2H steps in one launch.
//
// Equal bit for bit to the plain version (recognize/hv.py::_greedy_verify):
// active u8[B, H], steps i32[B] (always 2H: no step is skipped) and improved
// i32[B], from explained u8[B, H, Ns] (0/1, already masked by validity),
// outliers f32[B, H] (counts, +inf on invalid hypotheses: a non-finite entry
// reads 0, as out_vec does) and valid u8[B, H]. The plain version prices a
// flip as _cost's float32 expression (-C + lo * O) + lm * M over the flipped
// pattern, with C the covered points, O the outlier sum and M the points'
// cover beyond one: every term is an integer-valued float32, exact in any
// summation order while H * Ns < 2^24 (the wrapper checks it) and the
// outliers are counts. So this kernel keeps C, M and O as integer counts,
// updated by each flip, and rebuilds the same float32 expression from them,
// each operation rounded on its own (__fmul_rn, __fadd_rn; the file is built
// with --fmad=false): flipping h on covers C + popc(ex_h & ~covered) points,
// flipping it off C - popc(ex_h & once), the cover sum moves by |ex_h| and O
// by out_h. An invalid hypothesis's flip leaves the pattern as it is and
// costs the current pattern's cost. The step takes the first minimum (ties
// to the lowest h, as top_k(-costs, 1) does) and moves when it is below the
// current cost less float32(1e-6).
//
// What bounds it on the card: neither bytes nor operations. One read of
// explained (393 KB at H = 48, Ns = 8192, ~0.1 us at 3.35 TB/s) and
// 2H * H * ceil(Ns / 32) word operations (1.2 M) are nothing; the 2H steps
// are a chain, each depending on the last. So the design keeps everything a
// step touches on one SM: explained bit-packed (H * ceil(Ns / 32) words, 48
// KB at the cell's shape) in shared memory when it fits (else in a global
// workspace, read through L1), the covered and exactly-once bit planes in
// shared memory, the counts in registers. A step is one pass of the block's
// 32 warps over (hypothesis, 256-word chunk) items, 8 words a lane and a
// warp reduction each, one barrier, one warp pricing the H flips and taking
// the first minimum with two warp reductions, one barrier, and, on the ~2%
// of steps that move, an update of the bit planes and a third barrier. On
// one H100 at H = 48, Ns = 8192 a search took 0.229 ms of device time with
// 8 words a lane, 0.316 with 2 and 0.422 with 1 (0.253 with 512 threads):
// ~2.4 us a step, the chain of barriers and shared-memory round trips.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneWords = 8;                  // words a lane reads an item
constexpr int kItemWords = 32 * kLaneWords;    // words of one item
constexpr unsigned kFull = 0xffffffffu;

// _cost's float32 expression from integer counts
__device__ __forceinline__ float cost_of(int covered, float outliers,
                                         int multiple, float lo, float lm) {
  return __fadd_rn(__fadd_rn(-static_cast<float>(covered),
                             __fmul_rn(lo, outliers)),
                   __fmul_rn(lm, static_cast<float>(multiple)));
}

// an unsigned key in the order of the (finite) float, -0 folded into +0
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// four bool bytes (element 0 in the low byte) -> four bits
__device__ __forceinline__ uint32_t bits4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t bits16(uint4 q) {
  return bits4(q.x) | bits4(q.y) << 4 | bits4(q.z) << 8 | bits4(q.w) << 12;
}

template <bool kSharedEx>
__global__ void __launch_bounds__(kThreads)
hv_greedy_kernel(const uint8_t* __restrict__ explained,
                 const float* __restrict__ outliers,
                 const uint8_t* __restrict__ valid, uint32_t* workspace,
                 uint8_t* __restrict__ active, int* __restrict__ steps,
                 int* __restrict__ improved, int H, int Ns, float lo,
                 float lm, bool vec) {
  extern __shared__ uint32_t smem[];
  const int W = (Ns + 31) / 32;
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t* s_cov = smem;                    // [W] cover >= 1
  uint32_t* s_once = s_cov + W;              // [W] cover == 1
  int* s_cnt = reinterpret_cast<int*>(s_once + W);  // [H] this step's counts
  int* s_size = s_cnt + H;                   // [H] |ex_h|
  float* s_out = reinterpret_cast<float*>(s_size + H);  // [H]
  int* s_act = reinterpret_cast<int*>(s_out + H);       // [H]
  int* s_valid = s_act + H;                  // [H]
  int* s_pick = s_valid + H;                 // the move: h (-1: none), on,
                                             // its count, its cost's bits
  uint32_t* ex = kSharedEx ? reinterpret_cast<uint32_t*>(s_pick + 4)
                           : workspace + static_cast<size_t>(b) * H * W;

  for (int w = t; w < W; w += kThreads) s_cov[w] = s_once[w] = 0;
  for (int h = t; h < H; h += kThreads) {
    const float o = outliers[static_cast<size_t>(b) * H + h];
    s_cnt[h] = s_act[h] = 0;
    s_out[h] = isfinite(o) ? o : 0.0f;
    s_valid[h] = valid[static_cast<size_t>(b) * H + h] != 0;
  }
  // pack explained: word w of row h holds points 32w .. 32w + 31, bit i
  // point 32w + i, zeros past Ns
  const uint8_t* exb = explained + static_cast<size_t>(b) * H * Ns;
  for (int i = t; i < H * W; i += kThreads) {
    const int h = i / W, w = i - h * W;
    const uint8_t* p = exb + static_cast<size_t>(h) * Ns + 32 * w;
    const int n = min(32, Ns - 32 * w);
    uint32_t bits = 0;
    if (vec) {                  // Ns % 16 == 0 and 16-byte aligned rows
      bits = bits16(*reinterpret_cast<const uint4*>(p));
      if (n > 16) bits |= bits16(*reinterpret_cast<const uint4*>(p + 16)) << 16;
    } else {
      for (int k = 0; k < n; ++k) bits |= static_cast<uint32_t>(p[k] != 0) << k;
    }
    ex[i] = bits;
  }
  __syncthreads();
  for (int h = warp; h < H; h += kWarps) {
    int n = 0;
    for (int w = lane; w < W; w += 32) n += __popc(ex[static_cast<size_t>(h) * W + w]);
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) s_size[h] = n;
  }
  __syncthreads();

  // every thread keeps the current pattern's counts and cost
  int C = 0, S = 0, moves = 0;
  float O = 0.0f;
  float cur = cost_of(0, 0.0f, 0, lo, lm);
  const float margin = static_cast<float>(1e-6);   // Python's 1e-6 in float32
  const int chunks = (W + kItemWords - 1) / kItemWords;
  for (int step = 0; step < 2 * H; ++step) {
    // 1. each valid hypothesis's flip count, one (h, chunk) item a warp
    for (int it = warp; it < H * chunks; it += kWarps) {
      const int h = it / chunks;
      if (!s_valid[h]) continue;             // the same h for the whole warp
      const bool on = !s_act[h];
      const uint32_t* e = ex + static_cast<size_t>(h) * W;
      const int w0 = (it - h * chunks) * kItemWords + lane;
      int n = 0;
#pragma unroll
      for (int k = 0; k < kLaneWords; ++k) {
        const int w = w0 + 32 * k;
        if (w < W) n += __popc(e[w] & (on ? ~s_cov[w] : s_once[w]));
      }
      n = __reduce_add_sync(kFull, n);
      if (lane == 0 && n != 0) atomicAdd(&s_cnt[h], n);
    }
    __syncthreads();
    // 2. warp 0 prices every flip and takes the first minimum
    if (warp == 0) {
      unsigned key = UINT_MAX, idx = UINT_MAX;
      float best = 0.0f;
      int best_n = 0, best_on = 0;
      for (int h = lane; h < H; h += 32) {  // ascending: ties keep the first
        const int on = !s_act[h], n = s_cnt[h];
        float c;
        if (s_valid[h]) {
          const int c2 = on ? C + n : C - n;
          const int s2 = on ? S + s_size[h] : S - s_size[h];
          const float o2 = on ? __fadd_rn(O, s_out[h]) : __fsub_rn(O, s_out[h]);
          c = cost_of(c2, o2, s2 - c2, lo, lm);
        } else {
          c = cost_of(C, O, S - C, lo, lm);
        }
        const unsigned k = order_key(c);
        if (k < key) key = k, idx = h, best = c, best_n = n, best_on = on;
      }
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const int j = static_cast<int>(
          __reduce_min_sync(kFull, key == kmin ? idx : UINT_MAX));
      const float cj = __shfl_sync(kFull, best, j & 31);
      const int nj = __shfl_sync(kFull, best_n, j & 31);
      const int on = __shfl_sync(kFull, best_on, j & 31);
      const bool better = cj < __fsub_rn(cur, margin);
      if (lane == 0) {
        s_pick[0] = better ? j : -1;
        if (better) {
          s_pick[1] = on, s_pick[2] = nj, s_pick[3] = __float_as_int(cj);
          s_act[j] = on;
        }
      }
      __syncwarp();
      for (int h = lane; h < H; h += 32) s_cnt[h] = 0;
    }
    __syncthreads();
    // 3. on a move, every thread updates its counts, and the bit planes
    const int j = s_pick[0];
    if (j >= 0) {                            // the same j for every thread
      const int on = s_pick[1], n = s_pick[2];
      C += on ? n : -n;
      S += on ? s_size[j] : -s_size[j];
      O = on ? __fadd_rn(O, s_out[j]) : __fsub_rn(O, s_out[j]);
      cur = __int_as_float(s_pick[3]);
      ++moves;
      const uint32_t* e = ex + static_cast<size_t>(j) * W;
      for (int w = t; w < W; w += kThreads) {
        if (on) {
          const uint32_t x = e[w], c = s_cov[w];
          s_once[w] = (s_once[w] & ~x) | (x & ~c);
          s_cov[w] = c | x;
        } else {                             // recount over the active set
          uint32_t ones = 0, twos = 0;
          for (int h = 0; h < H; ++h) {
            if (!s_act[h]) continue;
            const uint32_t x = ex[static_cast<size_t>(h) * W + w];
            twos |= ones & x;
            ones |= x;
          }
          s_cov[w] = ones;
          s_once[w] = ones & ~twos;
        }
      }
      __syncthreads();
    }
  }
  for (int h = t; h < H; h += kThreads)
    active[static_cast<size_t>(b) * H + h] = static_cast<uint8_t>(s_act[h]);
  if (t == 0) {
    steps[b] = 2 * H;
    improved[b] = moves;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kSharedEx>
int launch(size_t smem, const uint8_t* explained, const float* outliers,
           const uint8_t* valid, uint32_t* workspace, uint8_t* active,
           int* steps, int* improved, int B, int H, int Ns, float lo,
           float lm, cudaStream_t s) {
  cudaError_t rc = cudaFuncSetAttribute(
      hv_greedy_kernel<kSharedEx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const bool vec = Ns % 16 == 0 && aligned16(explained);
  hv_greedy_kernel<kSharedEx><<<B, kThreads, smem, s>>>(
      explained, outliers, valid, workspace, active, steps, improved, H, Ns,
      lo, lm, vec);
  return cudaGetLastError();
}

}  // namespace

// explained u8[B, H, Ns], outliers f32[B, H], valid u8[B, H] -> active
// u8[B, H], steps i32[B], improved i32[B]; workspace u32[B, H, ceil(Ns/32)]
// holds the packed explained when it does not fit in shared memory (the
// wrapper always passes it; it is not read otherwise). lo, lm: the outlier
// and multiple-assignment weights as float32. One CUDA block a frame, on
// `stream` (a cudaStream_t passed as void*); allocates nothing. Returns the
// launch's cudaError_t: 0 when it was accepted.
extern "C" int tj_hv_greedy(const uint8_t* explained, const float* outliers,
                            const uint8_t* valid, uint32_t* workspace,
                            uint8_t* active, int* steps, int* improved, int B,
                            int H, int Ns, float lo, float lm, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Ns < 0) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return rc;
  const size_t W = (static_cast<size_t>(Ns) + 31) / 32;
  const size_t state = 4 * (2 * W + 5 * static_cast<size_t>(H) + 4);
  const size_t packed = 4 * static_cast<size_t>(H) * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state + packed <= static_cast<size_t>(optin))
    return launch<true>(state + packed, explained, outliers, valid, workspace,
                        active, steps, improved, B, H, Ns, lo, lm, s);
  if (state <= static_cast<size_t>(optin))
    return launch<false>(state, explained, outliers, valid, workspace, active,
                         steps, improved, B, H, Ns, lo, lm, s);
  return cudaErrorInvalidValue;
}
