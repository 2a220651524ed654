// Flash (online-softmax) attention forward in float32 on Hopper's tensor cores (sm_90a):
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//
// over the keys j visible to query i: j < kv_len, and j <= i when causal, and
// j > i - window when a window is set.  q is (B, Hq, Sq, Dh), k and v are
// (B, Hkv, Skv, Dh) with Hq = group * Hkv (GQA; MQA at Hkv = 1), float32, each
// with any (batch, head, row) strides and a contiguous last axis, Dh <= 256.
// The output is float32 with its own strides.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_kernel_call`) on the float32 path;
// csrc/flash_attention_tc.cu takes bf16 and csrc/flash_attention.cu (SIMT)
// stays callable by name.  It computes what that kernel computes in float32:
// the scores, masks, a float32 running max, denominator and accumulator,
// o = acc / max(l, 1e-30), and 0 for a row that sees no key.  Where its
// arithmetic differs:
// * Both products run on the tensor cores as 3xTF32: each float32 operand a
//   splits into hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties
//   away, as cvt.rna.tf32.f32), and a b is summed as lo*hi + hi*lo + hi*hi in
//   float32 (lo*lo, below 2^-22 of |a b|, is dropped).  Each TF32 product is
//   exact in float32, so only the dropped term, the rounding of lo and the
//   order of float32 sums separate it from a float32 product.
// * The scores are the unscaled q . k, and the scale 1/sqrt(Dh) is folded into
//   exp2 with log2(e); the TPU kernel scales q first.
// * P (float32, after the exp) is split in registers as the A operand of
//   P . V; the denominator sums the unsplit p.
// ref.py::attention_tc_ref(products="3xtf32") at the kernel's key tile
// (ops.f32_block_k) computes this order in plain PyTorch.
//
// What bounds it on the card.  4 * Dh operations per visible (query, key)
// pair (two products, a multiply and an add each) against q, k, v and o read
// or written once.  At h2o-danube-3-4b's prefill (B 2, Hq 32, Hkv 8, S 8192,
// Dh 120, window 4096) that is 7.7e11 operations: 4.69 ms at 165 TFLOP/s
// (495 TF32 over the three products), against 0.08 ms for the bytes; at
// gemma-2b's (B 2, Hq 8, Hkv 1, S 8176, Dh 256, causal) 5.5e11, 3.32 ms.  So
// it is bound by the tensor cores, and the split is kept off their path.
//
// Design: one template over DC, the number of 32-float boxes in a padded row
// (Dp = 32 DC >= Dh; DC in {2, 4, 6, 8}), 256 threads a block.
// * One block per (batch * head, 64-row query tile).  Warpgroup 0 consumes:
//   wgmma for both products.  Warpgroup 1 produces: it loads Q once and each
//   K and V tile from global memory into registers (16-byte loads where the
//   tensors allow, else four 4-byte loads; zeros past Dh, Sq and kv_len),
//   splits every element once into hi and lo, and stores both into shared
//   memory.  So a K or V element is split once for the 64 query rows that use
//   it, and no consumer warp converts an operand.  The next tile's loads are
//   issued as soon as a tile is stored, so they are in flight while the
//   producer waits for the consumer to free a buffer.
// * Layout: TF32 wgmma reads its shared-memory operands only K-major.  Q and
//   K are rows of Dh (the contraction of QK^T): stored as DC boxes of rows of
//   32 floats with the 128-byte swizzle.  V is stored transposed (V^T: rows
//   of keys, the contraction of P.V), by the producer's stores, in the same
//   swizzle.  Within each group of 8 keys the producer writes key e at
//   position (e >> 1) + 4 (e & 1): the S accumulator holds columns 2t, 2t + 1
//   of an 8-key step where the TF32 A fragment wants columns t, t + 4 (PTX
//   ISA, the m64nNk8 fragments), and a sum over keys does not care about
//   their order, so P goes from the accumulator to the A operand with no
//   shuffle.
// * Key tiles (Smem<DC>::kKeys) by shared memory, at most 227 KiB a block:
//   64 keys up to Dp 128 (Q hi+lo 64 KiB, K hi+lo 64, V^T hi+lo 64: 192 KiB),
//   32 at Dp 192 (96 + 48 + 48), 16 at Dp 256 (128 + 32 + 64: a V^T row
//   keeps its 128-byte swizzle row, half of it used).  Registers: O is Dp / 2
//   a consumer thread (128 at Dh 256), S kKeys, P's hi and lo kKeys, a P.V
//   chunk up to 64; ptxas reports 217-255 registers and no spills.
// * One K and one V buffer, each with a full and an empty mbarrier: the
//   producer refills K while the consumer runs the softmax and P.V, and V
//   while it runs the next QK^T.  The producer's generic stores reach the
//   tensor cores' async proxy through fence.proxy.async before each arrival.
// * Per tile: S from two passes of wgmma over Dp / 8 steps: Q_hi against a
//   box's K_lo and K_hi rows as one B of 2 kKeys rows (Q_hi read from shared
//   memory once for both terms), then Q_lo K_hi^T onto the hi*lo half, and
//   S = (hi*lo + lo*hi) + hi*hi in float32; masks only on tiles at the
//   diagonal, the window's edge or kv_len; online softmax on the fragments
//   with exp2; P split; P.V as three passes of wgmma with P from registers,
//   into a fresh accumulator per tile, a chunk of at most 128 head dims at a
//   time, added to O (alpha O + P.V) in float32.  The tensor cores do not
//   round to nearest inside an instruction: with O itself as the
//   accumulator, the error grew with the row's keys and passed float32's
//   tolerance at gemma-2b's 8176 (tools/flash_f32_variants.py).
// * The grid's y axis walks the query tiles from the last: under a causal
//   mask the last tiles have the longest bands, and they start first.  Only
//   the causal/window band of key tiles is loaded.  No atomics: each block
//   writes its own rows, and two launches give identical bits.
// * Build without --use_fast_math: the division rounds as the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block: one consumer warpgroup
constexpr int kThreads = 256;  // warpgroup 0 consumes, warpgroup 1 loads and splits
constexpr int kBox = 32;       // floats in one 128-byte swizzled row
constexpr int kQBoxBytes = kBlockQ * kBox * 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int DC>  // boxes per row of Q and K: Dh <= 32 * DC
struct alignas(1024) Smem {
  static constexpr int kDp = kBox * DC;                            // padded head dim
  static constexpr int kKeys = DC <= 4 ? 64 : DC <= 6 ? 32 : 16;   // keys per tile
  static constexpr int kKeyBoxes = (kKeys + kBox - 1) / kBox;      // boxes per row of V^T
  static constexpr int kKBoxBytes = 2 * kKeys * kBox * 4;  // lo and hi rows of a box
  static constexpr int kVtBoxBytes = kDp * kBox * 4;
  float q[2][DC][kBlockQ * kBox];      // [hi, lo][box]: 64 rows of 32 floats
  float k[DC][2][kKeys * kBox];        // [box][lo, hi]: kKeys rows each, lo rows first
  float vt[2][kKeyBoxes][kDp * kBox];  // [hi, lo][key box]: Dp rows (head dims) of 32 keys
  uint64_t q_full, k_full, k_empty, v_full, v_empty;
};

// the padded head dim's boxes, and the key tile, of the instance that takes dh
constexpr int boxes_for(int dh) { return dh <= 64 ? 2 : dh <= 128 ? 4 : dh <= 192 ? 6 : 8; }
constexpr int keys_for(int dh) {
  return boxes_for(dh) == 2   ? Smem<2>::kKeys
         : boxes_for(dh) == 4 ? Smem<4>::kKeys
         : boxes_for(dh) == 6 ? Smem<6>::kKeys
                              : Smem<8>::kKeys;
}

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
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

// this thread's generic stores to shared memory, visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major tile: start
// address, leading and stride byte offsets (in 16-byte units), layout type 1 (B128)
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

// Round to TF32, to nearest with ties away from zero, as cvt.rna.tf32.f32
// does for finite values: add half of the 13 dropped bits' unit, then drop them.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));  // the difference is exact in float32
}

// A wgmma accumulator's registers d[i .. i + 7] as "+f" operands, and operand
// numbers of the instruction's accumulator list.
#define WG_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32(i) WG_D8(i), WG_D8(i + 8), WG_D8(i + 16), WG_D8(i + 24)
#define WG_R0_8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R0_16 WG_R0_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R0 WG_R0_16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
                       "%29, %30, %31"
#define WG_R32                                                                                 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R32_16 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R64                                                                                 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_R96                                                                            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "  \
  "%125, %126, %127"

// S: d (64 x N, float32) = A (64 x 8, K-major, shared) * B (N x 8, K-major, shared)
// [+ d if acc], TF32, N = 16 .. 128: a key tile, or its lo and hi rows
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" WG_R0_8
      "}, %8, %9, p, 1, 1;\n}\n"
      : WG_D8(0)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R0_16
      "}, %16, %17, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R0
      "}, %32, %33, p, 1, 1;\n}\n"
      : WG_D32(0)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_R0 ", " WG_R32
      "}, %64, %65, p, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "l"(a), "l"(b), "r"(acc));
}

// P.V: d (64 x N, float32) = A (64 x 8, TF32 registers) * B (N x 8, K-major, shared)
// [+ d if acc], N = 64, 96 or 128 head dims: one chunk of a tile's product
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R0
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {" WG_R0 ", " WG_R32_16
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : WG_D32(0), WG_D8(32), WG_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_R0 ", " WG_R32
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// Offset (floats) of element (r, c), c < 32, in a 1024-byte-aligned tile of
// 128-byte rows with the 128-byte swizzle: 16-byte chunk c / 4 of row r sits
// at chunk (c / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Floats 4c .. 4c + 3 of row `row` (< row_end) of a row-major tile with row
// stride ss, zero past dh and past row_end: one 16-byte load when the
// tensors allow it (vec), else four 4-byte ones.
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int64_t ss, int row,
                                        int row_end, int c, int dh, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < row_end && c < dh) {
    const float* p = src + row * ss + c;
    if (vec) {  // dh is a multiple of 4: the chunk is whole
      x = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      x.x = __ldg(p);
      if (c + 1 < dh) x.y = __ldg(p + 1);
      if (c + 2 < dh) x.z = __ldg(p + 2);
      if (c + 3 < dh) x.w = __ldg(p + 3);
    }
  }
  return x;
}

// The producer's share of a tile of R rows x Dp floats: warp w takes warp
// tiles w, w + 4, ... of 16 rows x two 4-float chunks; lane l holds row
// l / 2 and chunk l % 2 of its warp tile (two lanes read 32 contiguous bytes).
template <int R, int DP>
struct Share {
  static constexpr int kItems = (R / 16) * (DP / 8) / 4;  // 4-float chunks a thread
  static __device__ __forceinline__ void at(int n, int& row, int& chunk) {
    const int p = threadIdx.x % 128, wt = p / 32 + 4 * n, lane = p % 32;
    row = 16 * (wt % (R / 16)) + lane / 2;
    chunk = 2 * (wt / (R / 16)) + lane % 2;
  }
};

// split x (row, chunk) into hi and lo, stored K-major: box chunk / 8 (BOX
// floats apart), row `row`
template <int BOX>
__device__ __forceinline__ void store_rows(float* hi, float* lo, int row, int chunk, float4 x) {
  const int off = (chunk >> 3) * BOX + swz(row, (chunk & 7) << 2);
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// split x (key `key`, head dims 4 chunk ..) into hi and lo, stored transposed
// (V^T, K-major for P.V): key box key / 32, its key at position
// (e >> 1) + 4 (e & 1) of its group of 8 (e = key % 8), head dim d a row
template <int DP>
__device__ __forceinline__ void store_cols(float* hi, float* lo, int key, int chunk, float4 x) {
  const int kp = key % kBox;
  const int pos = (kp & ~7) | ((kp & 7) >> 1) | ((kp & 1) << 2);
  const int base = (key / kBox) * DP * kBox;
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t h, l;
    split_tf32(xs[j], h, l);
    const int off = base + swz(4 * chunk + j, pos);
    hi[off] = __uint_as_float(h);
    lo[off] = __uint_as_float(l);
  }
}

template <int DC>
__device__ __forceinline__ void produce(Smem<DC>& sm, const float* __restrict__ qb,
                                        const float* __restrict__ kb,
                                        const float* __restrict__ vb, int64_t qss, int64_t kss,
                                        int64_t vss, int q0, int sq, int dh, int t_lo,
                                        int n_tiles, int kv_len, bool vec) {
  using S = Smem<DC>;
  using QShare = Share<kBlockQ, S::kDp>;
  using KShare = Share<S::kKeys, S::kDp>;
  // Q once, in passes of 8 chunks a thread
#pragma unroll
  for (int n0 = 0; n0 < QShare::kItems; n0 += 8) {
    float4 x[8];
    int row[8], chunk[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      QShare::at(n0 + u, row[u], chunk[u]);
      x[u] = load4(qb, qss, q0 + row[u], sq, 4 * chunk[u], dh, vec);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      store_rows<kBlockQ * kBox>(sm.q[0][0], sm.q[1][0], row[u], chunk[u], x[u]);
  }
  fence_async_smem();
  mbar_arrive(&sm.q_full);

  // K and V tiles in registers: the next tile's loads are issued as soon as
  // this tile's elements are stored, so they land while the consumer works
  float4 xk[KShare::kItems], xv[KShare::kItems];
  int row[KShare::kItems], chunk[KShare::kItems];
#pragma unroll
  for (int n = 0; n < KShare::kItems; ++n) {
    KShare::at(n, row[n], chunk[n]);
    xk[n] = load4(kb, kss, t_lo * S::kKeys + row[n], kv_len, 4 * chunk[n], dh, vec);
    xv[n] = load4(vb, vss, t_lo * S::kKeys + row[n], kv_len, 4 * chunk[n], dh, vec);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int k1 = (t_lo + i + 1) * S::kKeys;  // the next tile's first key
    const bool more = i + 1 < n_tiles;
    const uint32_t free = (i & 1) ^ 1;         // the first pass finds the buffers free
    mbar_wait(&sm.k_empty, free);
#pragma unroll
    for (int n = 0; n < KShare::kItems; ++n)
      store_rows<2 * S::kKeys * kBox>(sm.k[0][1], sm.k[0][0], row[n], chunk[n], xk[n]);
    fence_async_smem();
    mbar_arrive(&sm.k_full);
    if (more) {
#pragma unroll
      for (int n = 0; n < KShare::kItems; ++n)
        xk[n] = load4(kb, kss, k1 + row[n], kv_len, 4 * chunk[n], dh, vec);
    }
    mbar_wait(&sm.v_empty, free);
#pragma unroll
    for (int n = 0; n < KShare::kItems; ++n)
      store_cols<S::kDp>(sm.vt[0][0], sm.vt[1][0], row[n], chunk[n], xv[n]);
    fence_async_smem();
    mbar_arrive(&sm.v_full);
    if (more) {
#pragma unroll
      for (int n = 0; n < KShare::kItems; ++n)
        xv[n] = load4(vb, vss, k1 + row[n], kv_len, 4 * chunk[n], dh, vec);
    }
  }
}

// Accumulator layout of wgmma m64nN (float32), thread t of the warpgroup:
// entry 4j + e holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column
// 8j + 2 (t % 4) + e % 2.  The TF32 A-register operand of m64nNk8 wants, for
// the k-step j, rows (t % 32) / 4 and + 8 at columns t % 4 and t % 4 + 4:
// entries {4j, 4j + 2, 4j + 1, 4j + 3} with V's keys permuted to match.
template <int DC>
__device__ __forceinline__ void consume(Smem<DC>& sm, float* __restrict__ ob, int64_t os,
                                        int q0, int sq, int dh, int t_lo, int n_tiles,
                                        int kv_len, float scale_log2, int causal, int window) {
  using S = Smem<DC>;
  constexpr int kKeys = S::kKeys, kDp = S::kDp;
  constexpr int kChunk = kDp <= 128 ? kDp : kDp / 2;  // head dims of one P.V product
  const int t = threadIdx.x, lane = t % 32;
  const int r0 = q0 + 16 * (t / 32) + lane / 4;  // the thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                 // its columns: c0 + 8j and c0 + 8j + 1

  float acc[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // [hi, lo] descriptors
  const uint64_t dq[2] = {smem_desc(sm.q[0][0], 16, 1024), smem_desc(sm.q[1][0], 16, 1024)};
  const uint64_t dk[2] = {smem_desc(sm.k[0][0], 16, 1024), smem_desc(sm.k[0][1], 16, 1024)};
  const uint64_t dv[2] = {smem_desc(sm.vt[0][0], 16, 1024), smem_desc(sm.vt[1][0], 16, 1024)};
  if (n_tiles > 0) mbar_wait(&sm.q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t phase = i & 1;
    const int k0 = (t_lo + i) * kKeys;

    // S = Q K^T, unscaled, over DC boxes in k-steps of 8: Q_hi [K_lo; K_hi]^T
    // in one product whose B is a box's lo and hi rows (Q_hi read once for
    // both), then Q_lo K_hi^T onto its first half: the two small terms sum
    // on the tensor cores, and S = (hi*lo + lo*hi) + hi*hi in float32
    float sa[kKeys];
    float(&small)[kKeys / 2] = *reinterpret_cast<float(*)[kKeys / 2]>(sa);
    mbar_wait(&sm.k_full, phase);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBox / 8; ++kk)
        wgmma_ss(sa, dq[0] + ((c * kQBoxBytes + kk * 32) >> 4),
                 dk[0] + ((c * S::kKBoxBytes + kk * 32) >> 4), c + kk);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBox / 8; ++kk)
        wgmma_ss(small, dq[1] + ((c * kQBoxBytes + kk * 32) >> 4),
                 dk[1] + ((c * S::kKBoxBytes + kk * 32) >> 4), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sa);
    if (lane == 0) mbar_arrive(&sm.k_empty);  // this warp is done with the K tile
    float sc[kKeys / 2];
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) sc[x] = sa[x] + sa[x + kKeys / 2];

    const bool edge = k0 + kKeys > kv_len || (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBlockQ - 1 - window);
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
    // P split into TF32 A fragments, straight from the accumulator's entries
    uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      split_tf32(sc[4 * j], ph[j][0], pl[j][0]);
      split_tf32(sc[4 * j + 2], ph[j][1], pl[j][1]);
      split_tf32(sc[4 * j + 1], ph[j][2], pl[j][2]);
      split_tf32(sc[4 * j + 3], ph[j][3], pl[j][3]);
    }

    // O = alpha O + P V, P V as lo*hi, hi*lo, hi*hi over the tile's keys in
    // k-steps of 8, into a fresh accumulator a chunk of head dims at a time,
    // added to O in float32: the tensor cores' accumulation inside an
    // instruction is not round-to-nearest, and O would take it over every
    // key of the row
    mbar_wait(&sm.v_full, phase);
#pragma unroll
    for (int h = 0; h < kDp / kChunk; ++h) {
      float pv[kChunk / 2];
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          wgmma_rs(pv, term == 0 ? pl[j] : ph[j],
                   dv[term == 1] + (((j / 4) * S::kVtBoxBytes + h * kChunk * kBox * 4 +
                                     (j % 4) * 32) >> 4),
                   term + j);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int x = 0; x < kChunk / 2; ++x)
        acc[h * kChunk / 2 + x] = acc[h * kChunk / 2 + x] * alpha[(x >> 1) & 1] + pv[x];
    }
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(&sm.v_empty);  // this warp is done with the V tile
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= dh) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sq) continue;
      ob[row * os + col] = acc[4 * j + 2 * r] / l[r];
      if (col + 1 < dh) ob[row * os + col + 1] = acc[4 * j + 2 * r + 1] / l[r];
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq, int group, int sq,
                 int dh, int kv_len, float scale_log2, int causal, int window, int vec,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int kKeys = Smem<DC>::kKeys;
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
    mbar_init(&sm.q_full, 128);   // every producer thread arrives after its stores
    mbar_init(&sm.k_full, 128);
    mbar_init(&sm.v_full, 128);
    mbar_init(&sm.k_empty, 4);    // one arrival per consumer warp
    mbar_init(&sm.v_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (n_tiles > 0)
      produce<DC>(sm, q + b * qs.b + h * qs.h, k + b * ks.b + hk * ks.h,
                  v + b * vs.b + hk * vs.h, qs.s, ks.s, vs.s, q0, sq, dh, t_lo, n_tiles, kv_len,
                  vec != 0);
  } else {
    consume<DC>(sm, o + b * os.b + h * os.h, os.s, q0, sq, dh, t_lo, n_tiles, kv_len,
                scale_log2, causal, window);
  }
}

struct Args {
  const float *q, *k, *v;
  float* o;
  int batch, hq, hkv, sq, skv, dh, kv_len, causal, window, vec;
  float scale_log2;
  Strides qs, ks, vs, os;
  cudaStream_t stream;
};

template <int DC>
int launch(const Args& a) {
  const int bytes = static_cast<int>(sizeof(Smem<DC>)) + 1024;
  auto kernel = flash_f32_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.hq, (a.sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, a.stream>>>(a.q, a.k, a.v, a.o, a.hq, a.hq / a.hkv, a.sq, a.dh,
                                              a.kv_len, a.scale_log2, a.causal, a.window, a.vec,
                                              a.qs, a.ks, a.vs, a.os);
  return cudaGetLastError();
}

}  // namespace

// The key tile of the instance that takes head dim dh (64 up to Dh 128, 32
// up to 192, 16 up to 256), or 0 where no instance does.  The wrapper's
// f32_block_k mirrors it.
extern "C" int flash_attention_f32_keys(int dh) { return dh < 1 || dh > 256 ? 0 : keys_for(dh); }

// float32 only.  vec: 1 when q, k and v start on 16 bytes and their strides
// and dh are multiples of 4 elements (16-byte loads), else 0.  window <= 0:
// no window.  Strides in elements, (batch, head, row) of q, k, v and o.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                                          int vec, int batch, int hq, int hkv, int sq, int skv,
                                          int dh, int kv_len, float scale, int causal,
                                          int window, int64_t qsb, int64_t qsh, int64_t qss,
                                          int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                                          int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                                          int64_t oss, void* stream) {
  if (flash_attention_f32_keys(dh) == 0 || hkv < 1 || hq % hkv != 0 || sq < 1 || kv_len < 0 ||
      kv_len > skv || (sq + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), batch, hq, hkv, sq, skv, dh,
               kv_len, causal, window, vec, scale * kLog2e,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
               static_cast<cudaStream_t>(stream)};
  switch (boxes_for(dh)) {
    case 2: return launch<2>(a);
    case 4: return launch<4>(a);
    case 6: return launch<6>(a);
    default: return launch<8>(a);
  }
}
