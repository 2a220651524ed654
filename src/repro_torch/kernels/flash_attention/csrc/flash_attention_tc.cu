// Flash (online-softmax) attention forward on Hopper's tensor cores (sm_90a), bf16:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//
// over the keys j visible to query i: j < kv_len, and j <= i when causal, and
// j > i - window when a window is set.  q is (B, Hq, Sq, Dh), k and v are
// (B, Hkv, Skv, Dh) with Hq = group * Hkv (GQA; MQA at Hkv = 1), bfloat16,
// each with any (batch, head, row) strides that are multiples of 8 elements
// (16 bytes), a contiguous last axis, 16-byte-aligned base pointers, and Dh a
// multiple of 8 up to 256.  The output is bf16 with its own strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_kernel_call`) on the bf16 path; the
// SIMT kernel csrc/flash_attention.cu keeps float32.  It computes what that
// kernel computes: float32 scores, masks, a float32 running max, denominator
// and accumulator, o = acc / max(l, 1e-30) in q's type, and 0 for a row that
// sees no key.  Where its arithmetic differs:
// * The scores are the unscaled bf16 q . k on the tensor cores, summed in
//   float32 (each bf16 x bf16 product is exact in float32), then scaled: the
//   TPU kernel scales q first.  Only the order of the sum and the place of the
//   scale differ.
// * P is rounded to bf16 before P . V, which runs on the tensor cores; the
//   denominator sums the float32 p.  The TPU kernel multiplies p and v in
//   float32 (kernel.py:55-76).  This is the one numerical departure:
//   |d o| <= 2^-9 * max|v| from P's rounding.  ref.py::attention_tc_ref
//   computes this order in plain PyTorch, at the kernel's key tile.
//
// What bounds it on the card.  4 * Dh operations per visible (query, key)
// pair (two products, a multiply and an add each) against q, k, v and o read
// or written once: at h2o-danube-3-4b's prefill (B 2, Hq 32, Hkv 8, S 8192,
// Dh 120, window 4096) 7.7e11 operations, 0.78 ms at 989 TFLOP/s bf16, against
// 0.04 ms for the bytes; at gemma-2b's (B 2, Hq 8, Hkv 1, S 8176, Dh 256,
// causal) 5.5e11 operations, 0.55 ms, against 0.05 ms.  It is bound by the
// tensor cores, so both products run as wgmma, and the softmax (the exp2 of
// every score) overlaps them across the two consumer warpgroups.
//
// Design: a TMA ring feeding warp-specialised wgmma, one template over DC,
// the number of 64-wide boxes in a row of a tile (Dh <= 64 * DC, DC = 1..4).
// * One block per (batch * head, 128-row query tile), 384 threads: warpgroups
//   0 and 1 consume, 64 query rows each; warpgroup 2 produces.  The grid's y
//   axis walks the query tiles from the last: under a causal mask the last
//   tiles have the longest bands, and they start first.
// * Producer: one thread issues TMA loads (cp.async.bulk.tensor, 4-d maps over
//   (Dh, S, H, B) built on the host from the tensors' own strides, so the
//   model's transposed (B, S, H, Dh) views load without a copy): the Q tile
//   once, then K and V tiles into a ring of kStages stages, with full and
//   empty mbarriers.  K and V have their own full barriers, so QK^T starts
//   while V is in flight.  setmaxnreg gives its registers to the consumers
//   (24 against 240).
// * Tiles: 128-byte swizzle, so a row of a box is 64 bf16 values; a tile is DC
//   boxes side by side.  TMA zero-fills what lies outside the tensor: the pad
//   columns Dh..64 DC - 1, a ragged Sq or Skv.
// * Key tiles (Smem<DC>::kKeys): 128 keys up to Dh 128, where S and O take 64
//   float32 registers each and P 32, within the consumers' 240.  Above 128, 64
//   keys: at Dh 256 O alone takes 128 registers (64 x 256 float32 over 128
//   threads), and S at 64 keys 32 more and P 16, 176 in all; at 128 keys S and
//   P would take 96 and pass 240.  Shared memory at Dh 256: Q 64 KiB and two
//   stages of K and V at 32 KiB each, 192 KiB, one block an SM.  (The same
//   choice as FlashAttention-3, Shah et al., arXiv:2407.08608, which serves
//   head dim 256 on the H100 with a smaller key tile than at 128.)
// * Consumers: S = Q K^T by wgmma m64nKk16 (K = the key tile) with both
//   operands in shared memory, over the DC boxes in k-steps of 16; the softmax
//   on the accumulator fragments, row max and sum by quad shuffles, exp2 with
//   scale * log2(e) folded in; masks only on tiles that touch the diagonal,
//   the window's edge or kv_len.  P is packed to bf16 in registers, where S's
//   accumulator layout is the A-operand layout of the next wgmma (m64nNk16,
//   N = 64 DC up to wgmma's widest 256, A in registers, V N-major in shared
//   memory).
// * Only the causal/window band of key tiles is loaded.  No atomics: each
//   block writes its own rows, and two launches give identical bits.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kBox = 64;        // bf16 values in one 128-byte swizzled row: a TMA box's width
constexpr int kThreads = 384;   // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kQBoxBytes = kBlockQ * kBox * 2;  // one box of the Q tile: 16 KiB
constexpr int kMaxBoxes = 4;    // Dh <= 256
constexpr float kLog2e = 1.4426950408889634f;

template <int DC>  // boxes per row of a tile: Dh <= 64 * DC
struct alignas(1024) Smem {
  static constexpr int kKeys = DC <= 2 ? 128 : 64;        // keys per K/V tile (see above)
  static constexpr int kKvBoxBytes = kKeys * kBox * 2;    // one box of a K or V tile
  __nv_bfloat16 q[DC][kBlockQ * kBox];
  __nv_bfloat16 k[kStages][DC][kKeys * kBox];
  __nv_bfloat16 v[kStages][DC][kKeys * kBox];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

// the key tile of the kernel that takes head dim dh
constexpr int keys_for(int dh) { return dh <= 2 * kBox ? Smem<2>::kKeys : Smem<4>::kKeys; }

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

// A wgmma accumulator's registers d[i .. i + 31] as "+f" operands, and the
// operand numbers %0 .. %127 of the instruction's accumulator list.
#define WG_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32(i) WG_D8(i), WG_D8(i + 8), WG_D8(i + 16), WG_D8(i + 24)
#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
              "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R32                                                                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R64                                                                                 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_R96                                                                            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "  \
  "%125, %126, %127"

// d (64 x 64, float32) = A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared) [+ d if acc]
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R0
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128, float32) = A (64 x 16, K-major, shared) * B (128 x 16, K-major, shared) [+ d if acc]
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R0 ", " WG_R32
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N, float32) += A (64 x 16, bf16 registers) * B (16 x N, N-major, shared), N = 64 ..
// 256 in steps of 64: the head dims of DC boxes
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R0
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R0 ", " WG_R32
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WG_R0 ", " WG_R32 ", " WG_R64
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32), WG_D32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_R0 ", " WG_R32 ", " WG_R64
      ", " WG_R96 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
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
  constexpr int kKeys = Smem<DC>::kKeys;
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
    const int k0 = (t_lo + i) * kKeys;

    // S = Q K^T, unscaled, over DC boxes of 64 head dims in k-steps of 16
    float sc[kKeys / 2];
    mbar_wait(&sm.k_full[s], phase);
    const uint64_t dk = smem_desc(sm.k[s][0], 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk)
        wgmma_ss(sc, dq + ((c * kQBoxBytes + kk * 32) >> 4),
                 dk + ((c * Smem<DC>::kKvBoxBytes + kk * 32) >> 4), c + kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool edge = k0 + kKeys > kv_len || (causal && k0 + kKeys - 1 > row_lo) ||
                      (window > 0 && k0 <= row_lo + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
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
    for (int j = 0; j < kKeys / 8; ++j) {
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
    for (int j = 0; j < kKeys / 8; ++j)
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
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    // O += P V: V's rows are the k dimension, its head dims (N, DC boxes) contiguous
    mbar_wait(&sm.v_full[s], phase);
    const uint64_t dv = smem_desc(sm.v[s][0], Smem<DC>::kKvBoxBytes, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
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
  constexpr int kKeys = Smem<DC>::kKeys, kKvBytes = DC * Smem<DC>::kKvBoxBytes;
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
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys - t_lo : 0;

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
      mbar_expect_tx(&sm.q_full, DC * kQBoxBytes);
#pragma unroll
      for (int c = 0; c < DC; ++c) tma_load(sm.q[c], &tm_q, &sm.q_full, c * kBox, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (t_lo + i) * kKeys;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);  // the first pass finds it free
        mbar_expect_tx(&sm.k_full[s], kKvBytes);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sm.k[s][c], &tm_k, &sm.k_full[s], c * kBox, k0, hk, b);
        mbar_expect_tx(&sm.v_full[s], kKvBytes);
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
// element strides, in boxes of 64 head dims x box_rows rows, 128-byte
// swizzle; what lies outside the tensor reads as zero.
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int dh, int rows,
                  int heads, int batch, int64_t sb, int64_t sh, int64_t ss, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, hq, hkv, sq, skv, dh, kv_len;
  float scale_log2;
  int causal, window;
  int64_t qs[3], ks[3], vs[3], os[3];  // (batch, head, row) strides in elements
  cudaStream_t stream;
};

template <int DC>
int launch(const Args& a, EncodeTiled encode) {
  // Q's box is the query tile; K's and V's the key tile of this instance
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, encode, a.q, a.dh, a.sq, a.hq, a.batch, a.qs[0], a.qs[1], a.qs[2],
                        kBlockQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, encode, a.k, a.dh, a.skv, a.hkv, a.batch, a.ks[0], a.ks[1], a.ks[2],
                 Smem<DC>::kKeys);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, encode, a.v, a.dh, a.skv, a.hkv, a.batch, a.vs[0], a.vs[1], a.vs[2],
                 Smem<DC>::kKeys);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int bytes = static_cast<int>(sizeof(Smem<DC>)) + 1024;
  auto kernel = flash_tc_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.hq, (a.sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.hq, a.hq / a.hkv, a.sq, a.dh, a.kv_len,
      a.scale_log2, a.causal, a.window, a.os[0], a.os[1], a.os[2]);
  return cudaGetLastError();
}

}  // namespace

// The key tile of the instance that takes head dim dh (128 up to Dh 128, 64
// above), or 0 where no instance does.  The wrapper's tc_block_k mirrors it.
extern "C" int flash_attention_tc_keys(int dh) {
  return dh < 8 || dh > kMaxBoxes * kBox || dh % 8 != 0 ? 0 : keys_for(dh);
}

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
  if (flash_attention_tc_keys(dh) == 0 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const Args a{q, k, v, o, batch, hq, hkv, sq, skv, dh, kv_len, scale * kLog2e, causal, window,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
               static_cast<cudaStream_t>(stream)};
  switch ((dh + kBox - 1) / kBox) {
    case 1: return launch<1>(a, encode);
    case 2: return launch<2>(a, encode);
    case 3: return launch<3>(a, encode);
    default: return launch<4>(a, encode);
  }
}
