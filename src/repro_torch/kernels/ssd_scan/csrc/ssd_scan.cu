// Mamba2 chunked SSD scan for Hopper (sm_90a):
//
//     h_t = exp(a_h dt_t) h_{t-1} + dt_t B_t (x) x_t      (an N x P state per (batch, head))
//     y_t = C_t^T h_t
//
// x is (B, S, H, P), dt (B, S, H), a (H,), B and C (B, S, N): one group, so the
// heads share B and C.  float32 in and out, any (batch, step, head) strides
// with a contiguous last axis; y is a new contiguous (B, S, H, P) tensor, and
// the final state (B, H, N, P) is written when asked (the decode cache).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py (`_kernel`,
// launched by `ssd_scan_kernel_call`).  It computes what that kernel computes,
// in the chunked dual form of Dao & Gu (arXiv:2405.21060), with s the
// cumulative log decay inside a chunk and xbar = dt * x:
//
//     y_i  = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) xbar_j  +  exp(s_i) C_i h
//     h'   = exp(s_last) h + sum_j B_j (x) (xbar_j exp(s_last - s_j))
//
// What bounds it on the card.  Per (batch, head) and chunk of L steps the
// work is the intra-chunk product over the causal half (L(L+1)/2 * P
// multiply-adds), C h (L*N*P) and the state update (L*N*P), plus C B^T once per
// (batch, chunk) for all heads (L(L+1)/2 * N).  At the serve shape (B 2, S
// 16384, H 80, P 64, N 128) and L 64 that is 9.7e10 operations, 1.45 ms at 67
// TFLOP/s float32, against 0.42 ms for the bytes (x, dt, B, C read once, y and
// the state written once): bound by operations.  This first kernel runs on the
// float32 pipes.
//
// Design, and where it departs from the TPU kernel:
// * The TPU grid (batch, head, chunk) carries the state across the chunk axis
//   in VMEM scratch, in order.  CUDA blocks run in no order, so one block owns
//   a (batch, head, 16-column slice of P) and loops over the chunks itself,
//   with the state in registers and shared memory.  The columns of the state
//   are independent, so slicing P gives B*H*P/16 blocks (640 at the serve
//   shape) where (batch, head) alone gives 160, 1.2 waves on 132 SMs.
// * C B^T is the same for every head: a first kernel computes it once per
//   (batch, chunk) into a scratch tensor of (B, S/L, L, L) floats that the
//   wrapper allocates.  The TPU kernel recomputes it for each head.
// * The chunk is L = 64, not the TPU's 128: the float32 tiles of one chunk at
//   N 128 then take 98 KB of shared memory, so two blocks fit on an SM.  The
//   chunk length changes only the rounding.
// * The decay is computed only where j <= i, and selected: exp(s_i - s_j) for
//   j > i can overflow to inf, and inf times a zero mask would give NaN.  The
//   TPU kernel computes it everywhere and drops j > i with `where`.
// * A ragged last chunk is masked by bounds (the TPU wrapper pads with dt = 0
//   steps); the carry uses the last real step's cumulative decay.
// * Each chunk's tiles are loaded into registers first, all loads at once
//   (unrolled, index math by shifts), then stored to shared memory: one round
//   trip to memory per chunk.  Loading them element by element in loops, each
//   iteration waiting on its load, left the kernel latency-bound (PERF.md).
// * Each block writes only its own outputs: no atomics, and two launches give
//   identical bits.
// * Thread layout: 256 threads as 16 row groups (ty) x 16 column lanes (tx).
//   For y, thread (ty, tx) owns rows 4ty..4ty+3 of column tx, reading the
//   decay-weighted scores and C transposed in shared memory as float4.  For
//   the state update it owns rows 8ty..8ty+7 of column tx, reading B as float4.
// * Build without --use_fast_math: expf rounds as the plain version's does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;        // L: steps per chunk
constexpr int kBlockP = 16;       // columns of P per block
constexpr int kThreads = 256;     // 16 row groups x 16 column lanes
constexpr int kMaxN = 128;        // state rows: 8 per row group
constexpr int kLdL = kChunk + 4;  // row stride of the transposed (., L) tiles: float4-aligned
// elements a thread loads per chunk: of B and of C (rows of kMaxN columns), of
// C B^T, and of x's 16-column slice
constexpr int kLoadBC = kChunk * kMaxN / kThreads;
constexpr int kLoadG = kChunk * kChunk / kThreads;
constexpr int kLoadX = kChunk * kBlockP / kThreads;
static_assert(kLoadBC * kThreads == kChunk * kMaxN && kThreads % kMaxN == 0, "B, C tiles");
static_assert(kLoadG * kThreads == kChunk * kChunk && kLoadX * kThreads == kChunk * kBlockP,
              "G, x tiles");

struct Strides3 {
  int64_t b, s, h;  // (batch, step, head)
};
struct Strides2 {
  int64_t b, s;  // (batch, step)
};

__host__ __device__ constexpr int ldb_of(int n) { return (n + 7) & ~7; }

__host__ __device__ constexpr int cb_smem_floats(int n) { return n * kLdL + kChunk * (n | 1); }

__host__ __device__ constexpr int scan_smem_floats(int n) {
  return kChunk * kLdL + n * kLdL + kChunk * ldb_of(n) + kChunk * kBlockP + ldb_of(n) * kBlockP +
         3 * kChunk;
}

// G[b, c, i, j] = C_{cL+i} . B_{cL+j} for one (chunk, batch) per block; rows
// past S are zero.  Thread (ty, tx) computes rows 4ty..4ty+3 and columns
// tx + 16k.  Bs has an odd row stride, so the 16 lanes reading one column hit
// 16 banks.
__global__ void __launch_bounds__(kThreads)
cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ g, int s,
          int n, Strides2 bs, Strides2 cs) {
  extern __shared__ float4 smem4[];
  const int ldo = n | 1;
  float* Ct = reinterpret_cast<float*>(smem4);  // [n][kLdL]: C transposed
  float* Bs = Ct + n * kLdL;                     // [L][ldo]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * kChunk, len = min(kChunk, s - t0);
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;
  const int kcol = tid % kMaxN;  // this thread's column of B and C
  float rb[kLoadBC], rc[kLoadBC];
#pragma unroll
  for (int r = 0; r < kLoadBC; ++r) {  // all loads first: in flight together
    const int i = (tid + r * kThreads) / kMaxN;
    const bool in = i < len && kcol < n;
    rb[r] = in ? bb[(t0 + i) * bs.s + kcol] : 0.f;
    rc[r] = in ? cb[(t0 + i) * cs.s + kcol] : 0.f;
  }
  if (kcol < n) {
#pragma unroll
    for (int r = 0; r < kLoadBC; ++r) {
      const int i = (tid + r * kThreads) / kMaxN;
      Ct[kcol * kLdL + i] = rc[r];
      Bs[i * ldo + kcol] = rb[r];
    }
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k = 0; k < n; ++k) {
    const float4 cv = *reinterpret_cast<const float4*>(&Ct[k * kLdL + 4 * ty]);
    float bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * ldo + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[0][q] = fmaf(cv.x, bv[q], acc[0][q]);
      acc[1][q] = fmaf(cv.y, bv[q], acc[1][q]);
      acc[2][q] = fmaf(cv.z, bv[q], acc[2][q]);
      acc[3][q] = fmaf(cv.w, bv[q], acc[3][q]);
    }
  }
  float* gb = g + (static_cast<int64_t>(b) * gridDim.x + c) * kChunk * kChunk;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) gb[(4 * ty + r) * kChunk + tx + 16 * q] = acc[r][q];
}

// One block per (16-column slice of P, head, batch), looping over the chunks.
// Two blocks fit on an SM by shared memory; the bound keeps the registers
// (the staged loads take 84 a thread) within that.
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ g, float* __restrict__ y, float* __restrict__ state_out,
            int s, int nh, int p, int n, Strides3 xs, Strides3 ds, Strides2 bs, Strides2 cs) {
  extern __shared__ float4 smem4[];
  const int ldb = ldb_of(n);
  float* Wt = reinterpret_cast<float*>(smem4);  // [L][kLdL]: W[i][j] at Wt[j][i]
  float* Ct = Wt + kChunk * kLdL;                // [n][kLdL]: C transposed
  float* Bs = Ct + n * kLdL;                     // [L][ldb]; columns past n are 0
  float* Xb = Bs + kChunk * ldb;                 // [L][kBlockP]: xbar = dt * x
  float* Hs = Xb + kChunk * kBlockP;             // [ldb][kBlockP]: the carried state
  float* Sc = Hs + ldb * kBlockP;                // [L]: cumulative log decay s
  float* Wl = Sc + kChunk;                       // [L]: exp(s_last - s_j)
  float* Dt = Wl + kChunk;                       // [L]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int pc = blockIdx.x * kBlockP + tx;  // this thread's column of P
  const bool col_in = pc < p;
  const bool owns_state = 8 * ty < ldb;
  const float a_h = a[hh];
  const float* xb = x + b * xs.b + hh * xs.h;
  const float* db = dt + b * ds.b + hh * ds.h;
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;
  const int nc = (s + kChunk - 1) / kChunk;

  float hreg[8];  // h[8ty + k][tx]
#pragma unroll
  for (int k = 0; k < 8; ++k) hreg[k] = 0.f;
  for (int e = tid; e < ldb * kBlockP; e += kThreads) Hs[e] = 0.f;

  const int kcol = tid % kMaxN;  // this thread's column of B and C
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk, len = min(kChunk, s - t0);
    // Every global load of the chunk first, into registers.  The loads are
    // independent and their index math is shifts, so they are in flight
    // together, and they overlap the previous chunk's state update: one round
    // trip to memory per chunk, not one per element.
    float rb[kLoadBC], rc[kLoadBC], rg[kLoadG], rx[kLoadX], d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int r = 0; r < kLoadBC; ++r) {
      const int j = (tid + r * kThreads) / kMaxN;
      const bool in = j < len && kcol < n;
      rb[r] = in ? bb[(t0 + j) * bs.s + kcol] : 0.f;
      rc[r] = in ? cb[(t0 + j) * cs.s + kcol] : 0.f;
    }
    const float* gc = g + (static_cast<int64_t>(b) * nc + c) * kChunk * kChunk;
#pragma unroll
    for (int r = 0; r < kLoadG; ++r) rg[r] = gc[tid + r * kThreads];
#pragma unroll
    for (int r = 0; r < kLoadX; ++r) {
      const int j = (tid + r * kThreads) / kBlockP;  // column tx
      rx[r] = j < len && col_in ? xb[(t0 + j) * xs.s + pc] : 0.f;
    }
    if (tid < 32) {
      if (lane < len) d0 = db[(t0 + lane) * ds.s];
      if (lane + 32 < len) d1 = db[(t0 + lane + 32) * ds.s];
    }
    __syncthreads();  // the last chunk's tiles are read

    if (tid < 32) {  // the inclusive scan of the log decay a * dt
      Dt[lane] = d0;
      Dt[lane + 32] = d1;
      float v0 = a_h * d0, v1 = a_h * d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      Sc[lane] = v0;
      Sc[lane + 32] = v1;
    }
#pragma unroll
    for (int r = 0; r < kLoadBC; ++r) {  // rows past len and columns past n are 0
      const int j = (tid + r * kThreads) / kMaxN;
      if (kcol < ldb) Bs[j * ldb + kcol] = rb[r];
      if (kcol < n) Ct[kcol * kLdL + j] = rc[r];
    }
    __syncthreads();

    const float s_last = Sc[len - 1];
#pragma unroll
    for (int r = 0; r < kLoadX; ++r) {
      const int j = (tid + r * kThreads) / kBlockP;
      Xb[j * kBlockP + tx] = rx[r] * Dt[j];
    }
#pragma unroll
    for (int r = 0; r < kLoadG; ++r) {
      const int e = tid + r * kThreads, i = e / kChunk, j = e % kChunk;
      // select, never multiply by a mask: exp(s_i - s_j) may be inf for j > i
      Wt[j * kLdL + i] = j <= i && i < len ? rg[r] * expf(Sc[i] - Sc[j]) : 0.f;
    }
    if (tid < kChunk) Wl[tid] = expf(s_last - Sc[tid]);
    __syncthreads();

    // y for rows 4ty..4ty+3 of column tx: W xbar + exp(s_i) C h
    float yi[4] = {0.f, 0.f, 0.f, 0.f}, yc[4] = {0.f, 0.f, 0.f, 0.f};
    const int j_end = min(len, 4 * ty + 4);  // W[i][j] = 0 for j > i
    for (int j = 0; j < j_end; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(&Wt[j * kLdL + 4 * ty]);
      const float xv = Xb[j * kBlockP + tx];
      yi[0] = fmaf(w4.x, xv, yi[0]);
      yi[1] = fmaf(w4.y, xv, yi[1]);
      yi[2] = fmaf(w4.z, xv, yi[2]);
      yi[3] = fmaf(w4.w, xv, yi[3]);
    }
    for (int k = 0; k < n; ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(&Ct[k * kLdL + 4 * ty]);
      const float hv = Hs[k * kBlockP + tx];
      yc[0] = fmaf(c4.x, hv, yc[0]);
      yc[1] = fmaf(c4.y, hv, yc[1]);
      yc[2] = fmaf(c4.z, hv, yc[2]);
      yc[3] = fmaf(c4.w, hv, yc[3]);
    }
    if (col_in) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        if (i < len)
          y[((static_cast<int64_t>(b) * s + t0 + i) * nh + hh) * p + pc] =
              yi[r] + expf(Sc[i]) * yc[r];
      }
    }
    __syncthreads();  // Hs read

    // h = exp(s_last) h + sum_j B_j (x) (xbar_j exp(s_last - s_j)), rows 8ty..8ty+7
    if (owns_state) {
      float u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = 0.f;
      for (int j = 0; j < len; ++j) {
        const float xw = Xb[j * kBlockP + tx] * Wl[j];
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[j * ldb + 8 * ty]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[j * ldb + 8 * ty + 4]);
        u[0] = fmaf(b0.x, xw, u[0]);
        u[1] = fmaf(b0.y, xw, u[1]);
        u[2] = fmaf(b0.z, xw, u[2]);
        u[3] = fmaf(b0.w, xw, u[3]);
        u[4] = fmaf(b1.x, xw, u[4]);
        u[5] = fmaf(b1.y, xw, u[5]);
        u[6] = fmaf(b1.z, xw, u[6]);
        u[7] = fmaf(b1.w, xw, u[7]);
      }
      const float decay = expf(s_last);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        hreg[k] = decay * hreg[k] + u[k];
        Hs[(8 * ty + k) * kBlockP + tx] = hreg[k];
      }
    }
  }

  if (state_out != nullptr && owns_state && col_in) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int row = 8 * ty + k;
      if (row < n) state_out[((static_cast<int64_t>(b) * nh + hh) * n + row) * p + pc] = hreg[k];
    }
  }
}

}  // namespace

// Floats of the C B^T scratch the wrapper allocates for a (batch, s) launch.
extern "C" int64_t ssd_scan_scratch_floats(int batch, int s) {
  return static_cast<int64_t>(batch) * ((s + kChunk - 1) / kChunk) * kChunk * kChunk;
}

// Strides in elements: x and dt (batch, step, head), B and C (batch, step).
// state may be null.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* a, const float* bm,
                               const float* cm, float* scratch, float* y, float* state, int batch,
                               int s, int nh, int p, int n, int64_t xsb, int64_t xss, int64_t xsh,
                               int64_t dsb, int64_t dss, int64_t dsh, int64_t bsb, int64_t bss,
                               int64_t csb, int64_t css, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || nh < 1 || nh > 65535 || p < 1 || n < 1 ||
      n > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides2 bs{bsb, bss}, cs{csb, css};
  const int nc = (s + kChunk - 1) / kChunk;

  const int cb_bytes = cb_smem_floats(n) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cb_bytes);
  if (err != cudaSuccess) return err;
  cb_kernel<<<dim3(nc, batch), kThreads, cb_bytes, st>>>(bm, cm, scratch, s, n, bs, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int scan_bytes = scan_smem_floats(n) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
  if (err != cudaSuccess) return err;
  scan_kernel<<<dim3((p + kBlockP - 1) / kBlockP, nh, batch), kThreads, scan_bytes, st>>>(
      x, dt, a, bm, cm, scratch, y, state, s, nh, p, n, Strides3{xsb, xss, xsh},
      Strides3{dsb, dss, dsh}, bs, cs);
  return cudaGetLastError();
}
