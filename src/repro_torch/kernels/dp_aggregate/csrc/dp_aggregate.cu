// Fused DP aggregation for Hopper (sm_90a): clip every client row to L2 <= C,
// optionally add Gaussian noise, and reduce the (M, d) update matrix to
//
//     sum_released  (d,)  = sum_i clip(u_i) + n_i
//     sq_released   ()    = sum_i ||clip(u_i) + n_i||^2
//     sq_clipped    ()    = sum_i ||clip(u_i)||^2
//
// Replaces the Pallas TPU kernel src/repro/kernels/dp_aggregate/kernel.py
// (`_kernel`, launched by `dp_aggregate_kernel_call`) and its noise-only twin
// (`_noise_only_kernel`, launched by `ldp_noise_kernel_call`).
//
// What bounds it on the card.  None mode: bytes, the update matrix read once,
// M*d*4 at 3.35 TB/s; operand mode streams the (M, d) noise matrix too,
// 2*M*d*4 bytes.  Fused mode reads M*d*4 bytes, but the counter generator
// adds ~131 operations per element (Threefry-2x32-20 and Box-Muller), which
// at 67 TFLOP/s take longer than the bytes: it is bound by operations.
//
// Design, and where it departs from the TPU kernel:
// * A row's clip scale needs the whole row's norm before any element of it
//   can enter the column sum, and a row of d = 131072 floats (512 KiB) fits in
//   no block's shared memory.  So the reduction is three launches:
//     A  row_scale   one 256-thread block per row: ||u_i||^2 and the scale
//                    min(1, C / sqrt(max(||u_i||^2, eps)))       (reads M*d)
//     B  column      a (ceil(d/256), splits) grid: each thread owns one column
//                    and walks a contiguous range of rows, writing its partial
//                    column sum and (noisy modes) a per-block partial of the
//                    released squares                            (reads M*d)
//     C  finalize    sums the `splits` partials of every column and, in one
//                    extra block, the scalar partials, in a fixed order.
//   B reads the matrix a second time, so this simple design sits at no better
//   than twice the byte bound at large d (at d = 500 the second read hits the
//   50 MB L2).  Keeping row groups L2-resident between A and B is later work.
// * The TPU grid runs in order and carries the sums across steps.  CUDA blocks
//   run in parallel, so every block writes partial sums and C reduces them in
//   a fixed order.  No float atomics: two launches give identical bits.
// * The TPU kernel takes the column sum as `ones @ tile` on its MXU.  Here it
//   is a plain per-thread accumulation; no cuBLAS.
// * No padding copy: ragged M and d are masked by bounds.
// * Noise: the TPU draws from its hardware PRNG; interpret mode keys
//   Threefry-2x32 by the block-local lane and grid step.  Here Threefry-2x32-20
//   is keyed by (seed, 0x9E3779B9) with the counter (global row, column), so
//   the noise does not depend on the tiling, and `row_start` offsets the rows
//   of a slice of the cohort.  Box-Muller turns the two 32-bit outputs of one
//   call into one N(0, 1).  The plain PyTorch version (ref.py) computes the
//   same generator; build without --use_fast_math so logf/cosf/sqrtf round as
//   PyTorch's own float ops do.  Products that meet an addition are written
//   with __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA: fused
//   mode then releases exactly clip(u) + (sigma * z), as operand mode does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;
constexpr uint32_t kThreefryC = 0x1BD11BDAu;  // Threefry key-schedule constant
constexpr uint32_t kGolden = 0x9E3779B9u;     // second key word
constexpr float kTwoPi = 6.2831855f;          // float32(2 * pi)

enum Mode { kNone = 0, kOperand = 1, kFused = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round Threefry-2x32, as repro/kernels/dp_aggregate/kernel.py:56.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kThreefryC};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int j = 1; j <= 5; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[(j - 1) % 2][i]);
      x1 ^= x0;
    }
    x0 += ks[j % 3];
    x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
  }
}

// uint32 -> float32 uniform in the open interval (0, 1) from the top 24 bits.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return (static_cast<float>(b >> 8) + 0.5f) * 5.9604644775390625e-08f;
}

// Standard normal for (seed, global row, column).
__device__ __forceinline__ float gaussian(uint32_t seed, uint32_t row,
                                          uint32_t col) {
  uint32_t x0 = row, x1 = col;
  threefry2x32(seed, kGolden, x0, x1);
  const float r = sqrtf(-2.0f * logf(bits_to_unit(x0)));
  return r * cosf(kTwoPi * bits_to_unit(x1));
}

// Sum over the block in a fixed order; the result is valid in thread 0.
// blockDim.x must be a multiple of 32.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (static_cast<int>(threadIdx.x) < nwarps) ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // warp_sums may be reused by the next call
  return v;
}

// A: squared norm and clip scale of every row; grid (M,).
__global__ void row_scale_kernel(const float* __restrict__ u, int64_t d,
                                 float clip, float* __restrict__ row_sq,
                                 float* __restrict__ scale) {
  const int64_t row = blockIdx.x;
  const float* p = u + row * d;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) acc = fmaf(p[j], p[j], acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    row_sq[row] = acc;
    scale[row] = fminf(1.0f, clip / sqrtf(fmaxf(acc, kEps)));
  }
}

// B: partial column sums over a range of rows; grid (ceil(d/256), splits).
template <int kMode>
__global__ void column_kernel(const float* __restrict__ u,
                              const float* __restrict__ noise,
                              const float* __restrict__ scale, int64_t m,
                              int64_t d, int64_t rows_per_split, float sigma,
                              uint32_t seed, int64_t row_start,
                              float* __restrict__ col_partial,
                              float* __restrict__ sq_partial) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r1 = min(m, r0 + rows_per_split);
  float acc = 0.0f, sq = 0.0f;
  if (col < d) {
#pragma unroll 4
    for (int64_t i = r0; i < r1; ++i) {
      float v = __fmul_rn(u[i * d + col], scale[i]);
      if (kMode == kOperand) v = __fadd_rn(v, noise[i * d + col]);
      if (kMode == kFused) {
        const float z = gaussian(seed, static_cast<uint32_t>(row_start + i),
                                 static_cast<uint32_t>(col));
        v = __fadd_rn(v, __fmul_rn(sigma, z));
      }
      acc += v;
      if (kMode != kNone) sq = fmaf(v, v, sq);
    }
    col_partial[blockIdx.y * d + col] = acc;
  }
  if (kMode != kNone) {
    sq = block_sum(sq);
    if (threadIdx.x == 0) sq_partial[blockIdx.y * gridDim.x + blockIdx.x] = sq;
  }
}

// C: fixed-order reduction of the partials; grid (ceil(d/256) + 1,).
__global__ void finalize_kernel(const float* __restrict__ col_partial, int splits,
                                int64_t d, const float* __restrict__ sq_partial,
                                int n_sq_partial, const float* __restrict__ row_sq,
                                const float* __restrict__ scale, int64_t m,
                                int mode, float* __restrict__ sum_out,
                                float* __restrict__ sq_rel_out,
                                float* __restrict__ sq_clip_out) {
  if (blockIdx.x + 1 < gridDim.x) {
    const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col < d) {
      float s = 0.0f;
      for (int k = 0; k < splits; ++k) s += col_partial[k * d + col];
      sum_out[col] = s;
    }
    return;
  }
  float c = 0.0f;
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
    const float sc = scale[i];
    c += row_sq[i] * (sc * sc);
  }
  c = block_sum(c);
  float r = 0.0f;
  if (mode != kNone) {
    for (int k = threadIdx.x; k < n_sq_partial; k += blockDim.x) r += sq_partial[k];
    r = block_sum(r);
  }
  if (threadIdx.x == 0) {
    *sq_clip_out = c;
    *sq_rel_out = (mode == kNone) ? c : r;
  }
}

// Noise-only: out[i, j] = sigma * z(seed, row_start + i, j); grid-stride.
__global__ void noise_kernel(float* __restrict__ out, int64_t m, int64_t d,
                             float sigma, uint32_t seed, int64_t row_start) {
  const int64_t n = m * d;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = k / d, j = k - i * d;
    out[k] = __fmul_rn(sigma, gaussian(seed, static_cast<uint32_t>(row_start + i),
                                       static_cast<uint32_t>(j)));
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every launch goes on `stream`, no
// call synchronises, and the caller owns every buffer:
//   row_sq, scale (m,); col_partial (splits, d);
//   sq_partial (splits, ceil(d/256)); sum_out (d,); sq_rel_out, sq_clip_out (1,).
// Returns the first launch error (0 = cudaSuccess).
extern "C" int dp_aggregate_launch(const float* u, const float* noise, int mode,
                                   int64_t m, int64_t d, float clip, float sigma,
                                   uint32_t seed, int64_t row_start,
                                   int64_t rows_per_split, int splits,
                                   float* row_sq, float* scale, float* col_partial,
                                   float* sq_partial, float* sum_out,
                                   float* sq_rel_out, float* sq_clip_out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = static_cast<int>((d + kThreads - 1) / kThreads);
  row_scale_kernel<<<static_cast<unsigned>(m), kThreads, 0, s>>>(u, d, clip, row_sq, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(col_blocks, splits);
  switch (mode) {
    case kNone:
      column_kernel<kNone><<<grid, kThreads, 0, s>>>(
          u, noise, scale, m, d, rows_per_split, sigma, seed, row_start, col_partial, sq_partial);
      break;
    case kOperand:
      column_kernel<kOperand><<<grid, kThreads, 0, s>>>(
          u, noise, scale, m, d, rows_per_split, sigma, seed, row_start, col_partial, sq_partial);
      break;
    case kFused:
      column_kernel<kFused><<<grid, kThreads, 0, s>>>(
          u, noise, scale, m, d, rows_per_split, sigma, seed, row_start, col_partial, sq_partial);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<<<col_blocks + 1, kThreads, 0, s>>>(
      col_partial, splits, d, sq_partial, splits * col_blocks, row_sq, scale, m, mode,
      sum_out, sq_rel_out, sq_clip_out);
  return cudaGetLastError();
}

extern "C" int ldp_noise_launch(float* out, int64_t m, int64_t d, float sigma,
                                uint32_t seed, int64_t row_start, void* stream) {
  const int64_t n = m * d;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(out, m, d, sigma, seed, row_start);
  return cudaGetLastError();
}
