// Kernel unproject: a served depth frame into the organized chain's inputs.
//
// Replaces no TPU kernel: the JAX package unprojects a served frame on the
// host, in NumPy (tpu_joints/serve/depth.py::depth_to_cloud, then the
// isfinite mask, nan_to_num and the tile count of the server's frame).
// It was added because that host work took 18-23 ms of a 30-40 ms round
// trip on one H100's host, where the card's chain takes ~9 ms: the card now
// receives the 1.2 MB depth frame and makes the chain's img and vmask itself.
//
// Equal bit for bit to the server's NumPy frame and to the plain PyTorch
// version (serve/depth.py::unproject_reference): z = near + d * range, each
// operation rounded on its own (__fmul_rn, __fadd_rn; the file is built with
// --fmad=false), with near, range and max_valid the float32 values NumPy's
// weak scalars round to (a metric frame passes near 0, range 1, max_valid
// +inf: 0 + d * 1 is d, except that -0 becomes +0, which is invalid either
// way). A pixel is valid when z is finite, 0 < z < max_valid, and
// x = z * xs[u] and y = z * ys[v] are finite. img holds (x, y, z) where z
// passes, with an overflowed x or y clamped to +-FLT_MAX as nan_to_num does,
// and 0 elsewhere; vmask the valid flag. Both are cropped to
// Hc = H - H % block rows and Wc = W - W % block columns. counts[0] is the
// number of block x block tiles of the crop with a valid pixel, counts[1]
// the valid pixels of the whole H x W frame.
//
// What bounds it on the card: bytes. 640 x 480 reads 1.23 MB of depth and
// writes 3.69 MB of img and 0.31 MB of vmask, ~1.6 us at 3.35 TB/s, and does
// a handful of operations a pixel. So the design is about coalescing: a CUDA
// block takes one band of `block` rows (one row of tiles) over 1024 columns,
// each thread one float4 of depth a row (all rows' loads issued before any
// is used); a row's 12-byte pixels are staged in shared memory and written
// out as whole 16-byte stores, the mask likewise. The tile flags live in
// shared memory for the band, so each CUDA block counts its tiles and valid
// pixels alone and adds them to counts once: integers, so the order of the
// adds cannot change the sums.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;   // columns of a CUDA block
constexpr int kMaxBlock = 16;          // serve/server.py::depth_block's largest

__device__ __forceinline__ float clamp_inf(float x) {
  return fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
}

__global__ void __launch_bounds__(kThreads)
unproject_kernel(const float* __restrict__ depth, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ img,
                 uint8_t* __restrict__ vmask, int* __restrict__ counts, int H,
                 int W, int block, float near, float range, float max_valid,
                 bool vec_in, bool vec_img, bool vec_mask) {
  __shared__ __align__(16) float s_img[3 * kChunk];
  __shared__ __align__(16) uint8_t s_mask[kChunk];
  __shared__ uint8_t s_tile[kChunk];
  __shared__ int s_count[2];

  const int t = threadIdx.x;
  const int Hc = H - H % block, Wc = W - W % block;
  const int u0 = blockIdx.x * kChunk;
  const int v0 = blockIdx.y * block;
  const int rows = min(block, H - v0);
  const int n = min(kChunk, W - u0);               // this chunk's columns
  // of them inside the crop; a band below the crop only counts valid pixels
  const int nc = v0 < Hc ? max(0, min(kChunk, Wc - u0)) : 0;
  const int c0 = 4 * t;                            // this thread's columns

  for (int i = t; i < kChunk; i += kThreads) s_tile[i] = 0;
  if (t < 2) s_count[t] = 0;

  float xv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) xv[k] = c0 + k < n ? xs[u0 + c0 + k] : 0.0f;

  float d[kMaxBlock][4];
#pragma unroll
  for (int r = 0; r < kMaxBlock; ++r) {
    if (r < rows) {
      const float* row = depth + (size_t)(v0 + r) * W + u0;
      if (vec_in) {                 // W % 4 == 0, so n % 4 == 0 too
        if (c0 < n) {
          const float4 q = *reinterpret_cast<const float4*>(row + c0);
          d[r][0] = q.x, d[r][1] = q.y, d[r][2] = q.z, d[r][3] = q.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + k < n) d[r][k] = row[c0 + k];
      }
    }
  }
  __syncthreads();                  // s_tile and s_count are zero

  int n_valid = 0;
#pragma unroll
  for (int r = 0; r < kMaxBlock; ++r) {
    if (r >= rows) break;
    const int v = v0 + r;
    const float yv = ys[v];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      if (c >= n) break;
      const float z = __fadd_rn(near, __fmul_rn(d[r][k], range));
      const bool ok = isfinite(z) && z > 0.0f && z < max_valid;
      const float x = __fmul_rn(z, xv[k]);
      const float y = __fmul_rn(z, yv);
      const bool valid = ok && isfinite(x) && isfinite(y);
      n_valid += valid;
      if (c < nc) {
        s_img[3 * c] = ok ? clamp_inf(x) : 0.0f;
        s_img[3 * c + 1] = ok ? clamp_inf(y) : 0.0f;
        s_img[3 * c + 2] = ok ? z : 0.0f;
        s_mask[c] = valid;
        if (valid) s_tile[c / block] = 1;
      }
    }
    __syncthreads();                // the row is staged
    if (nc > 0) {
      const size_t at = (size_t)v * Wc + u0;
      if (vec_img) {                // 16-byte aligned: Wc % 4 == 0
        float4* out = reinterpret_cast<float4*>(img + 3 * at);
        const float4* in = reinterpret_cast<const float4*>(s_img);
        for (int i = t; i < 3 * nc / 4; i += kThreads) out[i] = in[i];
      } else {
        for (int i = t; i < 3 * nc; i += kThreads) img[3 * at + i] = s_img[i];
      }
      if (vec_mask) {               // Wc % 16 == 0
        uint4* out = reinterpret_cast<uint4*>(vmask + at);
        const uint4* in = reinterpret_cast<const uint4*>(s_mask);
        for (int i = t; i < nc / 16; i += kThreads) out[i] = in[i];
      } else {
        for (int i = t; i < nc; i += kThreads) vmask[at + i] = s_mask[i];
      }
    }
    __syncthreads();                // the staging may be written again
  }

  int n_tiles = 0;
  for (int i = t; i < nc / block; i += kThreads) n_tiles += s_tile[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_tiles += __shfl_down_sync(0xffffffffu, n_tiles, o);
    n_valid += __shfl_down_sync(0xffffffffu, n_valid, o);
  }
  if ((t & 31) == 0) {
    atomicAdd(&s_count[0], n_tiles);
    atomicAdd(&s_count[1], n_valid);
  }
  __syncthreads();
  if (t == 0) {
    atomicAdd(&counts[0], s_count[0]);
    atomicAdd(&counts[1], s_count[1]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// depth f32[H, W], xs f32[W], ys f32[H] -> img f32[Hc, Wc, 3], vmask
// u8[Hc, Wc], counts i32[2] (zeroed here, then one add per CUDA block).
// Launches on `stream` (a cudaStream_t passed as void*) and returns the
// first cudaError_t of the memset and the launch: 0 when both were accepted.
// 1 <= block <= 16.
extern "C" int tj_unproject(const float* depth, const float* xs,
                            const float* ys, float* img, uint8_t* vmask,
                            int* counts, int H, int W, int block, float near,
                            float range, float max_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (rc != cudaSuccess) return rc;
  if (H <= 0 || W <= 0) return 0;
  if (block < 1 || block > kMaxBlock) return cudaErrorInvalidValue;
  const int Wc = W - W % block;
  const bool vec_in = W % 4 == 0 && aligned16(depth);
  const bool vec_img = Wc % 4 == 0 && aligned16(img);
  const bool vec_mask = Wc % 16 == 0 && aligned16(vmask);
  const dim3 grid((W + kChunk - 1) / kChunk, (H + block - 1) / block);
  unproject_kernel<<<grid, kThreads, 0, s>>>(
      depth, xs, ys, img, vmask, counts, H, W, block, near, range, max_valid,
      vec_in, vec_img, vec_mask);
  return cudaGetLastError();
}
