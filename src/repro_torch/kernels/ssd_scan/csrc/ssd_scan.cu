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
// in the chunk-parallel SSD of Dao & Gu (arXiv:2405.21060, section 7), with L
// the chunk, s the cumulative log decay inside a chunk and xbar = dt * x:
//
//   1. cb_kernel, per (batch, chunk):      G   = C B^T                    (L x L, all heads)
//   2. state_kernel, per (batch, chunk, head):
//                                          S_c = sum_j B_j (x) (xbar_j exp(s_last - s_j))
//   3. pass_kernel, per (batch, head, slice of N*P), over the chunks in order:
//                                          h_in(c) = exp(s_last(c-1)) h_in(c-1) + S_{c-1}
//      written in place over S_c; the state after the last chunk is the final state.
//   4. out_kernel, per (batch, chunk, head):
//                                          y = diag(exp(s)) (C h_in) + (G . D) xbar,
//      D_ij = exp(s_i - s_j) for j <= i.
//
// What bounds it on the card.  Per (batch, head) and chunk the products are
// L(L+1)/2 * P multiply-adds inside the chunk, L*N*P for C h_in and L*N*P for
// the chunk state, plus L(L+1)/2 * N for C B^T per (batch, chunk): at the
// serve shape (B 2, S 16384, H 80, P 64, N 128) and L 128, 1.08e11 operations,
// 0.65 ms on the tensor cores as 3xTF32 (below: three TF32 products each, 495
// TFLOP/s).  The count falls with L, to the recurrence's 2NP + P multiply-adds
// per (step, head) at L 1 (8.6e10, 0.52 ms): chip_smoke.py bounds the kernels
// by that, whatever their chunk.  The bytes the function must move (x, dt, B,
// C read once, y and the final state written once) take 0.42 ms; the stages
// add the state scratch's round trips (about 2.7 GB at L 128, 0.8 ms).
//
// Design:
// * Every product is mma.sync.m16n8k8 in TF32, three times: each float32
//   operand a splits into hi = tf32(a) and lo = tf32(a - hi), rounded to
//   nearest as cvt.rna rounds (in two integer instructions: sm_90 runs
//   cvt.rna as four), the difference exact in float32; the accumulator
//   (float32) takes lo*hi, hi*lo and hi*hi, and lo*lo is dropped.  That keeps
//   the products near float32 accuracy (the tests emulate it on the CPU);
//   TF32 alone would not.  The decay scaling is done in float32 before the
//   split.  A warp issues the three terms in turn over all its tiles, so
//   independent products lie between two that share an accumulator.
// * Only the state passing is sequential, and it is elementwise: the three
//   matrix stages run one block per (batch, chunk[, head, 64-column slice of
//   P]), B*nc*H blocks (20480 at the serve shape and L 128).
// * Operand tiles go into shared memory by cp.async (16 bytes where the
//   views' base and strides allow it, else 4), zero-filled past a ragged S,
//   past N (to a multiple of 8) and past P.  out_kernel loads C and h_in,
//   runs C h_in, then loads G and x into the same buffers: 106 KB at L 128,
//   two blocks an SM, one block's loads overlapping the other's products.
//   Separate buffers for all four (210 KB, one block an SM) and a ring of
//   32-step slabs (the decay applied as the fragments are read) both ran
//   slower on the H100.
// * Shared-memory row strides are chosen so that the fragment loads of a
//   warp hit 32 banks: 4 mod 32 where a fragment walks a row, 8 mod 32 where
//   it walks a column.
// * C B^T is computed once per (batch, chunk) for the heads; the decay matrix
//   G . D once per (batch, chunk, head), into shared memory, selected where
//   j <= i and never multiplied by a mask (exp(s_i - s_j) above the diagonal
//   may be inf).
// * out_kernel's 16-row tiles of the causal product are dealt to the warps in
//   pairs (i, 7 - i), so each warp does the same share of the triangle.
// * A ragged last chunk is masked by bounds; its carry uses the last real
//   step's s.  Each block writes only its own outputs: no atomics, and two
//   launches give identical bits.
// * L is 128: on the H100 it ran faster than 64 (PERF.md), with half the
//   state scratch.
// * Scratch (allocated by the wrapper): G (B, nc, L, L), the chunk states,
//   overwritten by the states entering each chunk, (B, nc, H, N, P), and
//   exp(s_last) per (B, H, nc).
// * Build without --use_fast_math: expf rounds as the plain version's does.
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kL = 128;        // steps per chunk (ops.CHUNK)
constexpr int kMaxN = 128;     // state rows
constexpr int kTileP = 64;     // columns of P per block
constexpr int kLdN = kMaxN + 4;   // (., N) tiles read along rows: 132 = 4 mod 32
constexpr int kLdNt = kMaxN + 8;  // B in the chunk state, read along columns: 136 = 8 mod 32
constexpr int kLdP = kTileP + 8;  // (., P) tiles, read along columns: 72 = 8 mod 32

struct Strides3 {
  int64_t b, s, h;  // (batch, step, head)
};
struct Strides2 {
  int64_t b, s;  // (batch, step)
};

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, ROWS) x columns [0, COLS) of a row-major global tile (row stride
// gs elements) into shared memory (row stride ld); entries past rows_in or
// cols_in are zero.  vec: 16-byte copies (base and strides 16-byte aligned,
// cols_in a multiple of 4), else 4-byte ones.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* sm, int ld, const float* gp, int64_t gs,
                                          int rows_in, int cols_in, bool vec) {
  if (vec) {
    constexpr int c4 = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * c4; e += kThreads) {
      const int r = e / c4, c = (e % c4) * 4;
      const bool in = r < rows_in && c < cols_in;
      cp_async16(sm + r * ld + c, in ? gp + r * gs + c : gp, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r < rows_in && c < cols_in;
      cp_async4(sm + r * ld + c, in ? gp + r * gs + c : gp, in);
    }
  }
}

// ---- 3xTF32 products on the tensor cores ---------------------------------

// Round to TF32, to nearest with ties away from zero, as cvt.rna.tf32.f32
// does for finite values: add half of the 13 dropped bits' unit, then drop
// them.  sm_90 runs cvt.rna as four instructions (with a check for inf, which
// no operand here is); this takes two.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));  // the difference is exact in float32
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt] += A[rows m0[mt].., k] * B[k, columns n0 + 8 nt..] over k < kend[mt]
// (multiples of 8; a tile with kend 0 is skipped), for one warp.  A is read
// as A(m, k) = a[m * lda + k], or a[k * lda + m] when A_KM (stored k-major);
// B as B(k, n) = b[k * ldb + n], or b[n * ldb + k] when B_NK.  Fragment
// layouts of m16n8k8 (g = lane / 4, t = lane % 4): A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g); the sum (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int MT, int NT, bool A_KM, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* a, int lda,
                                         const float* b, int ldb, const int (&m0)[MT],
                                         const int (&kend)[MT], int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int kmax = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) kmax = max(kmax, kend[i]);
  auto A = [&](int m, int k) { return A_KM ? a[k * lda + m] : a[m * lda + k]; };
  auto B = [&](int k, int n) { return B_NK ? b[n * ldb + k] : b[k * ldb + n]; };
  for (int k0 = 0; k0 < kmax; k0 += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(B(k0 + t, n0 + 8 * j + g), bh[j][0], bl[j][0]);
      split_tf32(B(k0 + t + 4, n0 + 8 * j + g), bh[j][1], bl[j][1]);
    }
    uint32_t ah[MT][4], al[MT][4];
    bool on[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      on[i] = k0 < kend[i];  // uniform across the warp
      if (!on[i]) continue;
      split_tf32(A(m0[i] + g, k0 + t), ah[i][0], al[i][0]);
      split_tf32(A(m0[i] + g + 8, k0 + t), ah[i][1], al[i][1]);
      split_tf32(A(m0[i] + g, k0 + t + 4), ah[i][2], al[i][2]);
      split_tf32(A(m0[i] + g + 8, k0 + t + 4), ah[i][3], al[i][3]);
    }
    // term by term over all the warp's tiles, small terms first: MT * NT
    // independent products lie between two that share an accumulator
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (on[i]) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (on[i]) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (on[i]) mma_tf32(acc[i][j], ah[i], bh[j]);
  }
}

// A warp's sums to out[r * ld + col] for rows m0 + g (+ 8) below rows and
// columns n0 + 8 nt + 2t (+ 1) below cols; in pairs (8-byte stores) where
// ld, cols and out's offset are even (pairs).
template <int MT, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[MT][NT][4], float* out, int64_t ld,
                                          const int (&m0)[MT], int n0, int rows, int cols,
                                          bool pairs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0[i] + g + 8 * h, col = n0 + 8 * j + tc;
        if (r >= rows || col >= cols) continue;
        float* o = out + r * ld + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          o[0] = acc[i][j][2 * h];
          if (col + 1 < cols) o[1] = acc[i][j][2 * h + 1];
        }
      }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// The two 16-row tiles of a warp in row group wm (0..3) of a 128-row output:
// the pair (wm, 7 - wm).
__device__ __forceinline__ void row_tiles(int wm, int (&m0)[2]) {
  m0[0] = 16 * wm;
  m0[1] = 16 * (7 - wm);
}

// ---- the log decay of a chunk ---------------------------------------------

// Warp 0 writes dt (zero past len) and the inclusive scan s of a * dt over the
// chunk's L steps to shared memory; lane k sums steps k L/32.. in order, then
// the lanes' sums are scanned.  The same code in every stage: the same bits.
__device__ __forceinline__ void chunk_decay(const float* __restrict__ dt, int64_t dss, float a_h,
                                            int len, float* Dt, float* Sc) {
  constexpr int per = kL / 32;
  const int lane = threadIdx.x & 31;
  float d[per], v[per], run = 0.f;
#pragma unroll
  for (int q = 0; q < per; ++q) {
    const int j = lane * per + q;
    d[q] = j < len ? dt[j * dss] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < per; ++q) {
    run += a_h * d[q];
    v[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // the lanes before this one
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int q = 0; q < per; ++q) {
    const int j = lane * per + q;
    Dt[j] = d[q];
    Sc[j] = excl + v[q];
  }
}

// ---- 1. C B^T per (batch, chunk) -------------------------------------------

__host__ __device__ constexpr int cb_smem_bytes() {
  return 2 * kL * kLdN * 4;
}

__global__ void __launch_bounds__(kThreads)
cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ g, int s,
          int n, Strides2 bs, Strides2 cs, bool bvec, bool cvec) {
  constexpr int MT = 2, NT = kL / 16;
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [L][kLdN]
  float* Bs = Cs + kL * kLdN;                    // [L][kLdN]
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * kL, len = min(kL, s - t0), np = round8(n);
  load_tile<kL, kMaxN>(Cs, kLdN, cm + b * cs.b + t0 * cs.s, cs.s, len, n, cvec);
  load_tile<kL, kMaxN>(Bs, kLdN, bm + b * bs.b + t0 * bs.s, bs.s, len, n, bvec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  int m0[MT], kend[MT];
  row_tiles(wm, m0);
#pragma unroll
  for (int i = 0; i < MT; ++i) kend[i] = m0[i] < len ? np : 0;
  float acc[MT][NT][4];
  zero(acc);
  const int n0 = wn * (kL / 2);
  warp_mma<MT, NT, false, true>(acc, Cs, kLdN, Bs, kLdN, m0, kend, n0);  // C (i, k) B (j, k)

  // every row, zero past len
  store_acc(acc, g + (static_cast<int64_t>(b) * gridDim.x + c) * kL * kL, kL, m0, n0, kL, kL, true);
}

// ---- 2. chunk states per (batch, chunk, head, P slice) ------------------------

__host__ __device__ constexpr int state_smem_bytes() {
  return (kL * kLdNt + kL * kLdP + 2 * kL + kL) * 4;
}

__global__ void __launch_bounds__(kThreads, 2)
state_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
             const float* __restrict__ bm, float* __restrict__ states, float* __restrict__ decay,
             int s, int nh, int p, int n, Strides3 xs, Strides3 ds, Strides2 bs, bool xvec,
             bool bvec) {
  constexpr int NT = kTileP / 16;
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [L][kLdNt]: B (j, n)
  float* Xs = Bs + kL * kLdNt;                   // [L][kLdP]: x, then x dt exp(s_last - s)
  float* Dt = Xs + kL * kLdP;                    // [L]
  float* Sc = Dt + kL;                           // [L]
  float* Wl = Sc + kL;                           // [L]: dt_j exp(s_last - s_j)
  const int hh = blockIdx.x % nh, ps = blockIdx.x / nh, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, p0 = ps * kTileP, pw = min(kTileP, p - p0);
  const int t0 = c * kL, len = min(kL, s - t0), lenp = round8(len), np = round8(n);
  load_tile<kL, kMaxN>(Bs, kLdNt, bm + b * bs.b + t0 * bs.s, bs.s, len, n, bvec);
  load_tile<kL, kTileP>(Xs, kLdP, x + b * xs.b + t0 * xs.s + hh * xs.h + p0, xs.s, len, pw, xvec);
  cp_async_commit();
  if (threadIdx.x < 32) {
    chunk_decay(dt + b * ds.b + t0 * ds.s + hh * ds.h, ds.s, a[hh], len, Dt, Sc);
    __syncwarp();
    const float s_last = Sc[len - 1];
    for (int j = threadIdx.x; j < kL; j += 32) Wl[j] = j < len ? Dt[j] * expf(s_last - Sc[j]) : 0.f;
    if (threadIdx.x == 0 && ps == 0)
      decay[(static_cast<int64_t>(b) * nh + hh) * nc + c] = expf(s_last);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < kL * kTileP; e += kThreads) {
    const int j = e / kTileP, q = e % kTileP;
    Xs[j * kLdP + q] *= Wl[j];
  }
  __syncthreads();

  // S (n, q) = sum_j B (j, n) Xw (j, q): A is B read k-major
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  int m0[2], kend[2];
  row_tiles(wm, m0);
#pragma unroll
  for (int i = 0; i < 2; ++i) kend[i] = m0[i] < np ? lenp : 0;
  float acc[2][NT][4];
  zero(acc);
  const int n0 = wn * (kTileP / 2);
  warp_mma<2, NT, true, false>(acc, Bs, kLdNt, Xs, kLdP, m0, kend, n0);

  store_acc(acc, states + ((static_cast<int64_t>(b) * nc + c) * nh + hh) * n * p + p0, p, m0, n0,
            n, pw, p % 2 == 0);
}

// ---- 3. state passing per (batch, head, slice of N*P) -------------------------

// h_in(0) = 0; h_in(c) = decay(c - 1) h_in(c - 1) + S_{c-1}, in place over S.
// Each thread owns V consecutive entries of the N*P state; it loads kAhead
// chunks' states before it stores any, so the loads are in flight together.
constexpr int kAhead = 8;

template <int V>
__global__ void __launch_bounds__(kThreads)
pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
            float* __restrict__ state_out, int nc, int nh, int64_t np_elems) {
  const int hh = blockIdx.y, b = blockIdx.z;
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= np_elems) return;
  const int64_t cstride = static_cast<int64_t>(nh) * np_elems;  // one chunk
  float* base = states + (static_cast<int64_t>(b) * nc * nh + hh) * np_elems + e;
  const float* dec = decay + (static_cast<int64_t>(b) * nh + hh) * nc;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float in[kAhead][V];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        if constexpr (V == 4) {
          const float4 f = *reinterpret_cast<const float4*>(base + (c0 + k) * cstride);
          in[k][0] = f.x, in[k][1] = f.y, in[k][2] = f.z, in[k][3] = f.w;
        } else {
          in[k][0] = base[(c0 + k) * cstride];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        const float d = dec[c0 + k];
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(base + (c0 + k) * cstride) =
              make_float4(h[0], h[1], h[2], h[3]);
        } else {
          base[(c0 + k) * cstride] = h[0];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = d * h[v] + in[k][v];
      }
    }
  }
  if (state_out != nullptr) {
    float* o = state_out + (static_cast<int64_t>(b) * nh + hh) * np_elems + e;
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = h[v];
  }
}

// ---- 4. chunk outputs per (batch, chunk, head, P slice) -----------------------

// C and h_in load first; once the C h_in product has read them, G and x load
// into their buffers: 106 KB at L 128, so two blocks share an SM and one's
// loads overlap the other's products.
__host__ __device__ constexpr int out_smem_bytes() {
  return (kL * kLdN + kMaxN * kLdP + 3 * kL) * 4;
}

__global__ void __launch_bounds__(kThreads, 2)
out_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const float* __restrict__ cm, const float* __restrict__ g,
           const float* __restrict__ states, float* __restrict__ y, int s, int nh, int p, int n,
           Strides3 xs, Strides3 ds, Strides2 cs, bool xvec, bool cvec, bool svec) {
  constexpr int MT = 2, NT = kTileP / 16, kLdL = kL + 4;  // kLdL = 4 mod 32
  static_assert(kL * kLdL <= kL * kLdN && kL <= kMaxN, "G and x fit C's and h_in's buffers");
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);          // [L][kLdN]: C (i, k)
  float* Hs = Cs + kL * kLdN;                            // [kMaxN][kLdP]: h_in (k, q)
  float* Ws = Cs;                                        // [L][kLdL]: G, then G . D
  float* Xs = Hs;                                        // [L][kLdP]: x, then xbar
  float* Dt = Hs + kMaxN * kLdP;                         // [L]
  float* Sc = Dt + kL;                                   // [L]
  float* Es = Sc + kL;                                   // [L]: exp(s_i)
  const int hh = blockIdx.x % nh, ps = blockIdx.x / nh, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, p0 = ps * kTileP, pw = min(kTileP, p - p0);
  const int t0 = c * kL, len = min(kL, s - t0), lenp = round8(len), np = round8(n);
  auto load_g_x = [&] {  // into C's and h_in's buffers
    load_tile<kL, kL>(Ws, kLdL, g + (static_cast<int64_t>(b) * nc + c) * kL * kL, kL, kL, kL, true);
    load_tile<kL, kTileP>(Xs, kLdP, x + b * xs.b + t0 * xs.s + hh * xs.h + p0, xs.s, len, pw,
                         xvec);
    cp_async_commit();
  };

  // C and h_in first, then G and x
  load_tile<kL, kMaxN>(Cs, kLdN, cm + b * cs.b + t0 * cs.s, cs.s, len, n, cvec);
  load_tile<kMaxN, kTileP>(
      Hs, kLdP, states + ((static_cast<int64_t>(b) * nc + c) * nh + hh) * n * p + p0, p, n, pw,
      svec);
  cp_async_commit();
  if (threadIdx.x < 32) {
    chunk_decay(dt + b * ds.b + t0 * ds.s + hh * ds.h, ds.s, a[hh], len, Dt, Sc);
    __syncwarp();
    for (int i = threadIdx.x; i < kL; i += 32) Es[i] = expf(Sc[i]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int gr = (threadIdx.x & 31) >> 2;
  const int n0 = wn * (kTileP / 2);
  int m0[MT], kend[MT];
  row_tiles(wm, m0);
  float acc[MT][NT][4];
  zero(acc);
  // C h_in, then each row times exp(s_i)
#pragma unroll
  for (int i = 0; i < MT; ++i) kend[i] = m0[i] < len ? np : 0;
  warp_mma<MT, NT, false, false>(acc, Cs, kLdN, Hs, kLdP, m0, kend, n0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float e0 = Es[m0[i] + gr], e1 = Es[m0[i] + gr + 8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[i][j][0] *= e0, acc[i][j][1] *= e0;
      acc[i][j][2] *= e1, acc[i][j][3] *= e1;
    }
  }

  __syncthreads();  // every warp has read C and h_in
  load_g_x();
  cp_async_wait<0>();
  __syncthreads();
  // the decay matrix once per (chunk, head), selected where j <= i < len
  for (int e = threadIdx.x; e < kL * kL; e += kThreads) {
    const int i = e / kL, j = e % kL;
    float* w = &Ws[i * kLdL + j];
    *w = j <= i && i < len ? *w * expf(Sc[i] - Sc[j]) : 0.f;
  }
  for (int e = threadIdx.x; e < kL * kTileP; e += kThreads) {
    const int j = e / kTileP, q = e % kTileP;
    Xs[j * kLdP + q] *= Dt[j];
  }
  __syncthreads();
  // (G . D) xbar over the causal half: the tile of rows m0.. needs k < m0 + 16
#pragma unroll
  for (int i = 0; i < MT; ++i) kend[i] = m0[i] < len ? min(m0[i] + 16, lenp) : 0;
  warp_mma<MT, NT, false, false>(acc, Ws, kLdL, Xs, kLdP, m0, kend, n0);

  store_acc(acc, y + ((static_cast<int64_t>(b) * s + t0) * nh + hh) * p + p0,
            static_cast<int64_t>(nh) * p, m0, n0, len, pw, p % 2 == 0);
}

bool aligned16(const void* ptr, std::initializer_list<int64_t> strides, int cols) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || cols % 4 != 0) return false;
  for (int64_t st : strides)
    if (st % 4 != 0) return false;
  return true;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Scratch {
  int64_t g, states, decay, total;  // offsets and size in floats
};

Scratch scratch_layout(int batch, int s, int nh, int p, int n) {
  const int64_t nc = (s + kL - 1) / kL;
  Scratch sc{};
  sc.g = 0;
  sc.states = batch * nc * kL * kL;
  sc.decay = sc.states + ((batch * nc * nh * n * p + 3) & ~int64_t{3});
  sc.total = sc.decay + batch * nh * nc;
  return sc;
}

cudaError_t launch(const float* x, const float* dt, const float* a, const float* bm,
                   const float* cm, float* scratch, float* y, float* state, int batch, int s,
                   int nh, int p, int n, Strides3 xs, Strides3 ds, Strides2 bs, Strides2 cs,
                   cudaStream_t st) {
  const int nc = (s + kL - 1) / kL, nps = (p + kTileP - 1) / kTileP;
  const Scratch sc = scratch_layout(batch, s, nh, p, n);
  float* g = scratch + sc.g;
  float* states = scratch + sc.states;
  float* decay = scratch + sc.decay;
  const bool xvec = aligned16(x, {xs.b, xs.s, xs.h}, p);
  const bool bvec = aligned16(bm, {bs.b, bs.s}, n), cvec = aligned16(cm, {cs.b, cs.s}, n);
  const bool svec = p % 4 == 0;  // the state scratch: contiguous (N, P) tiles, 16-byte based

  cudaError_t err = set_smem(cb_kernel, cb_smem_bytes());
  if (err != cudaSuccess) return err;
  cb_kernel<<<dim3(nc, batch), kThreads, cb_smem_bytes(), st>>>(bm, cm, g, s, n, bs, cs, bvec,
                                                                cvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(state_kernel, state_smem_bytes())) != cudaSuccess) return err;
  state_kernel<<<dim3(nh * nps, nc, batch), kThreads, state_smem_bytes(), st>>>(
      x, dt, a, bm, states, decay, s, nh, p, n, xs, ds, bs, xvec, bvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t np_elems = static_cast<int64_t>(n) * p;
  if (np_elems % 4 == 0) {
    const unsigned blocks = static_cast<unsigned>((np_elems / 4 + kThreads - 1) / kThreads);
    pass_kernel<4><<<dim3(blocks, nh, batch), kThreads, 0, st>>>(states, decay, state, nc, nh,
                                                                 np_elems);
  } else {
    const unsigned blocks = static_cast<unsigned>((np_elems + kThreads - 1) / kThreads);
    pass_kernel<1><<<dim3(blocks, nh, batch), kThreads, 0, st>>>(states, decay, state, nc, nh,
                                                                 np_elems);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(out_kernel, out_smem_bytes())) != cudaSuccess) return err;
  out_kernel<<<dim3(nh * nps, nc, batch), kThreads, out_smem_bytes(), st>>>(
      x, dt, a, cm, g, states, y, s, nh, p, n, xs, ds, cs, xvec, cvec, svec);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch the wrapper allocates for a launch: C B^T, the chunk
// states and the chunks' decays.
extern "C" int64_t ssd_scan_scratch_floats(int batch, int s, int nh, int p, int n) {
  return scratch_layout(batch, s, nh, p, n).total;
}

// Strides in elements: x and dt (batch, step, head), B and C (batch, step).
// state may be null.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* a, const float* bm,
                               const float* cm, float* scratch, float* y, float* state, int batch,
                               int s, int nh, int p, int n, int64_t xsb, int64_t xss, int64_t xsh,
                               int64_t dsb, int64_t dss, int64_t dsh, int64_t bsb, int64_t bss,
                               int64_t csb, int64_t css, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || nh < 1 || nh > 65535 || p < 1 || n < 1 ||
      n > kMaxN || (s + kL - 1) / kL > 65535 ||
      static_cast<int64_t>(nh) * ((p + kTileP - 1) / kTileP) > 2147483647)
    return cudaErrorInvalidValue;
  const Strides3 xs{xsb, xss, xsh}, ds{dsb, dss, dsh};
  const Strides2 bs{bsb, bss}, cs{csb, css};
  return launch(x, dt, a, bm, cm, scratch, y, state, batch, s, nh, p, n, xs, ds, bs, cs,
                static_cast<cudaStream_t>(stream));
}
