// Flash (online-softmax) attention forward on Hopper's tensor cores (sm_90a), bf16:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//
// over the keys j visible to query i: j < kv_len, and j <= i when causal, and
// j > i - window when a window is set.  q is (B, Hq, Sq, Dh), k and v are
// (B, Hkv, Skv, Dh) with Hq = group * Hkv (GQA; MQA at Hkv = 1), bfloat16,
// each with any (batch, head, row) strides that are multiples of 8 elements
// (16 bytes), a contiguous last axis, 16-byte-aligned base pointers, and Dh a
// multiple of 8 up to 128.  The output is bf16 with its own strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_kernel_call`) on the bf16 path; the
// SIMT kernel csrc/flash_attention.cu keeps float32 and Dh > 128.  It computes
// what that kernel computes: float32 scores, masks, a float32 running max,
// denominator and accumulator, o = acc / max(l, 1e-30) in q's type, and 0 for
// a row that sees no key.  Where its arithmetic differs:
// * The scores are the unscaled bf16 q . k on the tensor cores, summed in
//   float32 (each bf16 x bf16 product is exact in float32), then scaled: the
//   TPU kernel scales q first.  Only the order of the sum and the place of the
//   scale differ.
// * P is rounded to bf16 before P . V, which runs on the tensor cores; the
//   denominator sums the float32 p.  The TPU kernel multiplies p and v in
//   float32 (kernel.py:55-76).  This is the one numerical departure:
//   |d o| <= 2^-9 * max|v| from P's rounding.  ref.py::attention_tc_ref
//   computes this order in plain PyTorch.
//
// What bounds it on the card.  4 * Dh operations per visible (query, key)
// pair (two products, a multiply and an add each) against q, k, v and o read
// or written once: at the serve shape (B 2, Hq 32, Hkv 8, S 8192, Dh 120,
// window 4096) 7.7e11 operations, 0.78 ms at 989 TFLOP/s bf16, against 0.04 ms
// for the bytes.  It is bound by the tensor cores, so both products run as
// wgmma, and the softmax (the exp2 of every score) overlaps them across the
// two consumer warpgroups.
//
// Design: a TMA ring feeding warp-specialised wgmma.
// * One block per (batch * head, 128-row query tile), 384 threads: warpgroups
//   0 and 1 consume, 64 query rows each; warpgroup 2 produces.  The grid's y
//   axis walks the query tiles from the last: under a causal mask the last
//   tiles have the longest bands, and they start first.
// * Producer: one thread issues TMA loads (cp.async.bulk.tensor, 4-d maps over
//   (Dh, S, H, B) built on the host from the tensors' own strides, so the
//   model's transposed (B, S, H, Dh) views load without a copy): the Q tile
//   once, then K and V tiles of 128 keys into a ring of kStages stages, with
//   full and empty mbarriers.  K and V have their own full barriers, so QK^T
//   starts while V is in flight.  setmaxnreg gives its registers to the
//   consumers (24 against 240).
// * Tiles: 128-byte swizzle, so a row of a box is 64 bf16 values; Dh <= 64
//   takes one box per tile, Dh <= 128 two.  TMA zero-fills what lies outside
//   the tensor: the pad columns Dh..127, a ragged Sq or Skv.  Key tiles of 128
//   (not 64): S and O take 64 float32 registers each, P 32, within the
//   consumers' 240.
// * Consumers: S = Q K^T by wgmma m64n128k16 with both operands in shared
//   memory; the softmax on the accumulator fragments, row max and sum by quad
//   shuffles, exp2 with scale * log2(e) folded in; masks only on tiles that
//   touch the diagonal, the window's edge or kv_len.  P is packed to bf16 in
//   registers, where S's accumulator layout is the A-operand layout of the
//   next wgmma (m64nNk16, A in registers, V N-major in shared memory).
// * Only the causal/window band of key tiles is loaded.  No atomics: each
//   block writes its own rows, and two launches give identical bits.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kBlockK = 128;    // keys per tile
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kBox = 64;        // bf16 values in one 128-byte swizzled row: a TMA box's width
constexpr int kThreads = 384;   // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kBoxBytes = kBlockK * kBox * 2;  // one 128-row box: 16 KiB (Q's rows too)
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kBlockQ == kBlockK, "one box shape serves Q, K and V");

template <int DC>  // boxes per row of a tile: 1 for Dh <= 64, 2 for Dh <= 128
struct alignas(1024) Smem {
  __nv_bfloat16 q[DC][kBlockQ * kBox];
  __nv_bfloat16 k[kStages][DC][kBlockK * kBox];
  __nv_bfloat16 v[kStages][DC][kBlockK * kBox];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 | static_cast<uint64_t>(stride >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: the compiler must not move
// other accesses to them across the wait that follows it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128, float32) = A (64 x 16, K-major, shared) * B (128 x 16, K-major, shared) [+ d if acc]
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, float32) += A (64 x 16, bf16 registers) * B (16 x 128, N-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, bf16 registers) * B (16 x 64, N-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nN (float32), thread t of a warpgroup: entry
// 4j + e holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column
// 8j + 2 (t % 4) + e % 2.  The A-register operand of m64nNk16 wants, for the
// k-step kk, {entries 8kk + 0, 1}, {+2, 3}, {+4, 5}, {+6, 7} of that layout.
template <int DC>
__device__ __forceinline__ void consume(Smem<DC>& sm, __nv_bfloat16* __restrict__ ob, int64_t os,
                                        int wg, int q0, int sq, int dh, int t_lo, int n_tiles,
                                        int kv_len, float scale_log2, int causal, int window) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row_lo = q0 + 64 * wg;                // this warpgroup's first query row
  const int r0 = row_lo + 16 * (t / 32) + lane / 4;  // the thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                  // its columns: c0 + 8j and c0 + 8j + 1

  float acc[DC * 32];
#pragma unroll
  for (int i = 0; i < DC * 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&sm.q_full, 0);
  const uint64_t dq = smem_desc(sm.q[0] + 64 * wg * kBox, 16, 1024);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (t_lo + i) * kBlockK;

    // S = Q K^T, unscaled, over DC boxes of 64 head dims in k-steps of 16
    float sc[64];
    mbar_wait(&sm.k_full[s], phase);
    const uint64_t dk = smem_desc(sm.k[s][0], 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        const uint32_t off = (c * kBoxBytes + kk * 32) >> 4;
        wgmma_ss(sc, dq + off, dk + off, c + kk);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool edge = k0 + kBlockK > kv_len || (causal && k0 + kBlockK - 1 > row_lo) ||
                      (window > 0 && k0 <= row_lo + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + c0 + (e & 1), row = r0 + 8 * (e >> 1);
          const bool vis = col < kv_len && (!causal || col <= row) &&
                           (window <= 0 || col > row - window);
          if (!vis) sc[4 * j + e] = -INFINITY;
        }
    }

    // online softmax on the fragments; a row that has seen no key keeps m = -inf
    // and takes 0 as its base, so that its p and alpha are 0, not NaN
    float mx[2] = {m[0], m[1]}, base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * scale_log2;
      alpha[r] = exp2f(m[r] * scale_log2 - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -base[e >> 1]));
        sc[4 * j + e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // this thread's share of the row
#pragma unroll
    for (int j = 0; j < DC * 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    // O += P V: V's rows are the k dimension, its head dims (N) contiguous
    mbar_wait(&sm.v_full[s], phase);
    const uint64_t dv = smem_desc(sm.v[s][0], kBoxBytes, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      wgmma_rs(acc, pa[kk], dv + ((kk * 16 * kBox * 2) >> 4));  // 16 rows of 128 bytes a step
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DC * 8; ++j) {
    const int col = 8 * j + c0;  // even, and Dh is a multiple of 8: col < dh covers col + 1
    if (col >= dh) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(ob + row * os + col) =
            pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int hq,
                int group, int sq, int dh, int kv_len, float scale_log2, int causal, int window,
                int64_t osb, int64_t osh, int64_t oss) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle wants 1024-byte-aligned tiles; the launch adds 1 KiB of slack
  Smem<DC>& sm =
      *reinterpret_cast<Smem<DC>*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // the longest bands first
  // the band of key tiles any row of this block can see
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_hi = causal ? min(kv_len, q_last + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBlockK;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBlockK - 1) / kBlockK - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never rejoined: setmaxnreg needs it so.
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&sm.q_full, DC * kBoxBytes);
#pragma unroll
      for (int c = 0; c < DC; ++c) tma_load(sm.q[c], &tm_q, &sm.q_full, c * kBox, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (t_lo + i) * kBlockK;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);  // the first pass finds it free
        mbar_expect_tx(&sm.k_full[s], DC * kBoxBytes);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sm.k[s][c], &tm_k, &sm.k_full[s], c * kBox, k0, hk, b);
        mbar_expect_tx(&sm.v_full[s], DC * kBoxBytes);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sm.v[s][c], &tm_v, &sm.v_full[s], c * kBox, k0, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<DC>(sm, o + b * osb + h * osh, oss, threadIdx.x / 128, q0, sq, dh, t_lo, n_tiles,
                kv_len, scale_log2, causal, window);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over (Dh, rows, heads, batch) of a bf16 tensor with the given
// element strides, in boxes of 64 head dims x 128 rows, 128-byte swizzle;
// what lies outside the tensor reads as zero.
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int dh, int rows,
                  int heads, int batch, int64_t sb, int64_t sh, int64_t ss) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, kBlockK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
           int batch, int hq, int group, int sq, int dh, int kv_len, float scale_log2, int causal,
           int window, int64_t osb, int64_t osh, int64_t oss, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<DC>)) + 1024;
  auto kernel = flash_tc_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hq, (sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq,
                                            group, sq, dh, kv_len, scale_log2, causal, window,
                                            osb, osh, oss);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  window <= 0: no window.  Strides in elements, (batch, head, row)
// of q, k, v and o; the wrapper checks their alignment.  Returns a cudaError_t
// (0 on success), or -CUresult when a tensor map cannot be built
// (-CUDA_ERROR_NOT_FOUND when the driver has no cuTensorMapEncodeTiled).
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                                         int batch, int hq, int hkv, int sq, int skv, int dh,
                                         int kv_len, float scale, int causal, int window,
                                         int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                         int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                         int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                                         void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 != 0 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, encode, q, dh, sq, hq, batch, qsb, qsh, qss);
  if (r == CUDA_SUCCESS) r = make_map(&tk, encode, k, dh, skv, hkv, batch, ksb, ksh, kss);
  if (r == CUDA_SUCCESS) r = make_map(&tv, encode, v, dh, skv, hkv, batch, vsb, vsh, vss);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= kBox)
    return launch<1>(tq, tk, tv, o, batch, hq, hq / hkv, sq, dh, kv_len, scale_log2, causal,
                     window, osb, osh, oss, s);
  return launch<2>(tq, tk, tv, o, batch, hq, hq / hkv, sq, dh, kv_len, scale_log2, causal, window,
                   osb, osh, oss, s);
}
