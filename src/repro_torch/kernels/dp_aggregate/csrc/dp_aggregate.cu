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
// M*d*4 at 3.35 TB/s; operand mode streams the (M, d) noise matrix too.  Fused
// mode reads M*d*4 bytes and draws the noise: one Threefry-2x32-20 call (about
// 74 integer operations) gives two normals, so the generator's integer work,
// at 64 INT32 lanes per SM and clock, takes about as long as the bytes.
//
// Design, and where it departs from the TPU kernel:
// * One launch, u read from device memory once.  A row's clip scale needs
//   the whole row's norm before any element of it can enter the column sums,
//   and a row of d = 131072 floats (512 KiB) fits in no block's shared memory.
//   So a thread-block cluster of K <= 8 blocks owns a contiguous range of
//   rows, and block b of the cluster owns the column window [b*W, (b+1)*W)
//   of each of them.  Every row window arrives by a 1-D bulk copy
//   (cp.async.bulk, completion on an mbarrier) into a ring of 2-4 stages; the
//   last warp done with a stage refills it.  Each warp sums its part of the
//   window's squares and sends the partial into every peer's shared memory
//   (distributed shared memory), arriving on the peer's norm mbarrier; it
//   fetches or draws its noise while the partials travel, then waits for all
//   K * warps of them and sums them in a fixed order: every block holds the
//   same norm and clip scale, and no block-wide barrier is taken per row.  It
//   adds the window's released values into column sums held in registers,
//   from shared memory: the second touch of a row never leaves the SM.
// * Windows wider than the ring path's 16384 columns (d > 131072) take the
//   L2 path of the same kernel: no ring, the window read twice with plain
//   loads (the second read hits L2: one row per cluster is in flight and the
//   wrapper caps the clusters so that rows and column partials stay in about
//   24 MB of the 50 MB L2), the column sums kept in the cluster's scratch row.
// * The TPU grid runs in order and carries the sums across steps.  Here each
//   cluster writes its column sums, each block its squared-release sum, to
//   scratch.  The last block to finish a window (an integer ticket after
//   __threadfence) sums that window over the clusters in cluster order; the
//   last of those sums the scalars in a fixed order.  It sets the tickets
//   back to 0 for the next launch on the stream.  No float atomics: two
//   launches give identical bits.
// * The TPU kernel takes the column sum as `ones @ tile` on its MXU.  Here it
//   is a per-thread accumulation; no cuBLAS.
// * No padding copy: ragged M and d are masked by bounds.  A row window that
//   is not 16-byte aligned (d % 4 != 0) is copied from the aligned address
//   below it, with its offset; the copy then reads up to 12 bytes of the
//   neighbouring rows (or of the allocation's 16-byte granule at either end,
//   which lies in the same mapped page) and never uses them.
// * Noise: the TPU draws from its hardware PRNG; interpret mode keys
//   Threefry-2x32 by the block-local lane and grid step.  Here
//   Threefry-2x32-20 is keyed by (seed, 0x9E3779B9) with the counter (global
//   row, column pair k), so the noise does not depend on the tiling, and
//   `row_start` offsets the rows of a slice of the cohort.  Box-Muller turns
//   the call's two 32-bit outputs into two N(0, 1): rho cos(theta) for column
//   2k and rho sin(theta) for 2k + 1 (an odd d drops the last sine).  The
//   plain PyTorch version (ref.py) computes the same generator.  Built without
//   --use_fast_math, so logf/sincosf/sqrtf are the accurate routines (log of a
//   uniform near 1 needs it).  Products that meet an addition are written with
//   __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA: fused mode
//   then releases exactly clip(u) + (sigma * z), as operand mode does when fed
//   the noise-only kernel's matrix.
// * The clip threshold C comes as a float or, where it changes every round
//   on the device (adaptive clipping), as a pointer to a float there, read
//   in the kernel as the TPU kernel reads it from its scalar prefetch: the
//   host never reads C and nothing recompiles.
// * A sampled cohort (the masked-moment round) passes two optional device
//   arrays.  `row_gate` (float, (m,)): a row whose gate is not > 0 adds
//   nothing to any sum, whatever it holds (NaN included), draws no noise and
//   is not even copied in (its ring stage's barrier gets a plain arrival); a
//   gate > 0 enters the row once.  The TPU kernel is fed rows zeroed by
//   `where` outside it (repro/core/aggregation.py:329-343); here the zeroing
//   would not stop fused mode's noise, which is drawn inside.  `row_ids`
//   (int32, (m,)): each row's Threefry key in place of row_start + row, so a
//   gathered (cap, d) block of clients draws exactly their rows of the dense
//   (M, d) noise.  Both are read where the row's scale or noise is taken, as
//   C is.  With both null the kernel is the parent's: the gated code is a
//   second instance of the template (kGated), never the null-pointer one.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr uint32_t kThreefryC = 0x1BD11BDAu;  // Threefry key-schedule constant
constexpr uint32_t kGolden = 0x9E3779B9u;     // second key word
constexpr float kTwoPi = 6.2831855f;          // float32(2 * pi)
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 4;
constexpr int kNoiseThreads = 256;
constexpr int kNoisePairs = 4;  // column pairs per thread of the noise-only kernel
constexpr int kBadPlan = -1;    // dp_aggregate_launch: a plan the kernel does not take

enum Mode { kNone = 0, kOperand = 1, kFused = 2 };

// 20-round Threefry-2x32, as repro/kernels/dp_aggregate/kernel.py:56.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kThreefryC};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int j = 1; j <= 5; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[(j - 1) % 2][i]);  // rotate left
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

// The two standard normals of (seed, global row, column pair k): columns 2k, 2k + 1.
__device__ __forceinline__ float2 normal_pair(uint32_t seed, uint32_t row, uint32_t pair) {
  uint32_t x0 = row, x1 = pair;
  threefry2x32(seed, kGolden, x0, x1);
  const float rho = sqrtf(-2.0f * logf(bits_to_unit(x0)));
  float s, c;
  sincosf(kTwoPi * bits_to_unit(x1), &s, &c);
  return make_float2(rho * c, rho * s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a copy or partial that
// never lands (a fault of this kernel) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

struct Params {
  const float* u;        // (m, d)
  const float* noise;    // (m, d), operand mode
  int64_t m, d, row_start, rows_per_cluster;
  float clip, sigma;
  const float* clip_at;  // C in device memory, or nullptr: C is `clip`
  uint32_t seed;
  int window;            // W columns per block, a multiple of 4
  int stages;            // ring stages (ring path)
  int slot_floats;       // floats per ring stage
  float* colpart;        // (clusters, d) column sums of each cluster
  float* sqpart;         // (clusters * K) squared-release sums of each block
  float* clippart;       // (clusters) squared-clipped sums of each cluster
  int* tickets;          // K window tickets and one for the scalars; 0 at entry and exit
  float* out;            // sum_released (d), sq_released, sq_clipped
  // last, so that the fields above keep the offsets the ungated instance reads
  const float* row_gate; // (m,) a row enters the sums where its gate is > 0; or nullptr
  const int* row_ids;    // (m,) each row's noise key in place of row_start + row; or nullptr
};

// C for this launch: the parameter, or the float the pointer names.  Read
// where each row's scale is taken: a C loaded once at entry and held in a
// register cost the ring path 2-3% in none and operand modes
// (tools/dp_aggregate_variants.py).
__device__ __forceinline__ float clip_of(const Params& p) {
  return p.clip_at != nullptr ? __ldg(p.clip_at) : p.clip;
}

// Whether a row enters the sums (kGated: its gate is > 0, or there is no gate).
template <bool kGated>
__device__ __forceinline__ bool row_on(const Params& p, int64_t row) {
  return !kGated || p.row_gate == nullptr || __ldg(p.row_gate + row) > 0.0f;
}

// The row's Threefry counter word: its id (kGated with row_ids), else row_start + row.
template <bool kGated>
__device__ __forceinline__ uint32_t row_key(const Params& p, int64_t row) {
  if (kGated && p.row_ids != nullptr) return static_cast<uint32_t>(__ldg(p.row_ids + row));
  return static_cast<uint32_t>(p.row_start + row);
}

// Float offset of u[row, col0] from the 16-byte-aligned address below it.
__device__ __forceinline__ int misalignment(const Params& p, int64_t row, int64_t col0) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p.u + row * p.d + col0) & 15u) >> 2);
}

// Thread 0: bulk-copy the 16-byte-aligned span holding u[row, col0 : col0 + w] into `slot`.
// A gated-off row is not copied: its phase completes on a plain arrival.
template <bool kGated>
__device__ __forceinline__ void issue_row(const Params& p, int64_t row, int64_t col0, int w,
                                          float* slot, uint64_t* bar) {
  if (!row_on<kGated>(p, row)) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.u + row * p.d + col0);
  const uintptr_t a16 = a & ~static_cast<uintptr_t>(15);
  const uint32_t bytes = static_cast<uint32_t>((a - a16 + 4u * static_cast<uint32_t>(w) + 15u) &
                                               ~15u);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(slot)),
      "l"(a16), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A shared::cluster address of `addr` (this block's shared memory) in block `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(addr)), "r"(rank));
  return r;
}

// Warp-level sum that leaves the same bits in every lane (an xor butterfly:
// each step adds the same two values in every lane, and addition commutes).
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row norms are exchanged per warp, with no block-wide barrier: lane r of
// warp w of block b stores the warp's partial of row i into slot
// [i % 4][b * warps + w] of block r with st.async, which counts its 4 bytes on
// that block's norm barrier [i % 4] (one local arrival, K * warps * 4 bytes a
// phase; no cluster-scope fence).  A warp sends row i + 1 before it receives
// row i, so a peer may write row i + 4 only after every warp has sent row
// i + 2, which each does after receiving row i: four buffers never overwrite a
// slot that is still to be read, and a barrier's phase for row i + 4 cannot
// complete before every warp has waited on its phase for row i.
constexpr int kNormBufs = 4;
constexpr int kSlots = kMaxCluster * kMaxThreads / 32;

__device__ __forceinline__ void send_partial(float part, int i, int k, int b, int warps,
                                             float (*slots)[kSlots], uint64_t* norm_bar) {
  part = warp_allsum(part);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < k) {
    const uint32_t slot = peer_addr(&slots[i % kNormBufs][b * warps + warp], lane);
    const uint32_t bar = peer_addr(&norm_bar[i % kNormBufs], lane);
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::
                     "r"(slot),
                 "f"(part), "r"(bar)
                 : "memory");
  }
}

// Thread 0: open the phase of norm barrier [i % 4] that row i's partials complete.
__device__ __forceinline__ void expect_partials(int i, int k, int warps, uint64_t* norm_bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(&norm_bar[i % kNormBufs])),
               "r"(4 * k * warps)
               : "memory");
}

// ... and once every partial of row i has landed, every warp sums the K * warps
// slots in the same fixed order: the row's squared norm, the same bits in every
// block of the cluster.  Thread 0 then opens the barrier's phase for row i + 4.
__device__ __forceinline__ float receive_norm(int i, int k, int warps, int nrows,
                                              float (*slots)[kSlots], uint64_t* norm_bar) {
  mbar_wait(&norm_bar[i % kNormBufs], (i / kNormBufs) & 1);
  if (threadIdx.x == 0 && i + kNormBufs < nrows) expect_partials(i + kNormBufs, k, warps, norm_bar);
  const int lane = threadIdx.x & 31, n = k * warps;
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots / 32; ++j)
    if (lane + 32 * j < n) v += slots[i % kNormBufs][lane + 32 * j];
  return warp_allsum(v);
}

// Columns 2q and 2q + 1 of a window in shared memory (the second 0 past the
// window's end); an even alignment offset reads both in one 8-byte load.
__device__ __forceinline__ float2 load_pair(const float* x, int q, int w, bool even) {
  if (even) {
    const float2 v = reinterpret_cast<const float2*>(x)[q];
    return make_float2(v.x, 2 * q + 1 < w ? v.y : 0.0f);
  }
  return make_float2(x[2 * q], 2 * q + 1 < w ? x[2 * q + 1] : 0.0f);
}

// Release two columns of a row: clip(u) + noise into the column sums (and,
// with noise, their squares into sq); `odd` is false past the row's end.
template <int kMode>
__device__ __forceinline__ void release_pair(float2 u, float scale, bool odd, float n0, float n1,
                                             float& a0, float& a1, float& sq) {
  float v0 = __fmul_rn(u.x, scale);
  float v1 = __fmul_rn(u.y, scale);
  if (kMode != kNone) {
    v0 = __fadd_rn(v0, n0);
    v1 = odd ? __fadd_rn(v1, n1) : 0.0f;
    sq = fmaf(v0, v0, sq);
    sq = fmaf(v1, v1, sq);
  }
  a0 += v0;
  a1 += v1;
}

// This thread's sum of squares over its pairs of row i's window, once the row
// has landed in its ring stage (0 for an empty window or a gated-off row, whose
// stage holds no copy of it; its phase is still waited for, to keep the ring's
// parities).
template <int kPairs, bool kGated>
__device__ __forceinline__ float window_sq(const Params& p, const float* ring, uint64_t* full,
                                           int i, int64_t row0, int64_t col0, int w) {
  if (w == 0) return 0.0f;
  const int t = threadIdx.x, nt = blockDim.x, npairs = (w + 1) >> 1;
  const int off = misalignment(p, row0 + i, col0);
  const float* x = ring + (i % p.stages) * p.slot_floats + off;
  const bool even = (off & 1) == 0, whole = even && npairs == kPairs * nt && (w & 1) == 0;
  mbar_wait(&full[i % p.stages], (i / p.stages) & 1);
  float part = 0.0f;
  if (!row_on<kGated>(p, row0 + i)) return part;
  if (whole) {  // every pair of every thread in the window, 8-byte aligned
    const float2* x2 = reinterpret_cast<const float2*>(x);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const float2 v = x2[t + j * nt];
      part = fmaf(v.x, v.x, part);
      part = fmaf(v.y, v.y, part);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int q = t + j * nt;
      if (q < npairs) {
        const float2 v = load_pair(x, q, w, even);
        part = fmaf(v.x, v.x, part);
        part = fmaf(v.y, v.y, part);
      }
    }
  }
  return part;
}

// Block (cluster c, rank b) of the aggregation.  kPairs > 0: the ring path,
// each thread owning column pairs q = t + j * blockDim.x (j < kPairs) of the
// window; kPairs == 0: the L2 path.  Warps run through the rows on their own:
// a row's stage is refilled by the last warp to finish with it.  kGated: the
// instance that reads row_gate and row_ids (either may still be null).
template <int kMode, int kPairs, bool kGated>
__global__ void __launch_bounds__(kMaxThreads, 1) aggregate_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ uint64_t norm_bar[kNormBufs];
  __shared__ int stage_done[kMaxStages];
  __shared__ float slots[kNormBufs][kSlots];
  __shared__ float warp_part[kMaxThreads / 32];
  __shared__ int last;

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / k;
  const int clusters = gridDim.x / k;
  const int t = threadIdx.x, nt = blockDim.x, warps = nt >> 5, lane = t & 31;
  const int64_t row0 = c * p.rows_per_cluster;
  const int nrows = static_cast<int>(max(int64_t(0), min(p.m, row0 + p.rows_per_cluster) - row0));
  const int64_t col0 = static_cast<int64_t>(b) * p.window;
  const int w = static_cast<int>(max(int64_t(0), min(static_cast<int64_t>(p.window), p.d - col0)));
  const int npairs = (w + 1) >> 1;
  const uint32_t pair0 = static_cast<uint32_t>(col0 >> 1);
  float* ring = reinterpret_cast<float*>(smem_raw);
  float sq = 0.0f, clip_sq = 0.0f;

  if (t == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      stage_done[s] = 0;
    }
    for (int r = 0; r < kNormBufs; ++r) mbar_init(&norm_bar[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int r = 0; r < kNormBufs && r < nrows; ++r) expect_partials(r, k, warps, norm_bar);
  }
  cluster.sync();  // every peer has started (its shared memory is live), barriers initialised

  if constexpr (kPairs > 0) {
    if (t == 0 && w > 0)
      for (int i = 0; i < min(p.stages, nrows); ++i)
        issue_row<kGated>(p, row0 + i, col0, w, ring + i * p.slot_floats, &full[i]);
    float acc[2 * kPairs], nz[2 * kPairs];
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j) acc[j] = nz[j] = 0.0f;
    // A warp's rows run one ahead: it sends row i + 1's partial before it
    // waits for row i's norm, so the partials travel while row i is finished.
    if (nrows > 0) send_partial(window_sq<kPairs, kGated>(p, ring, full, 0, row0, col0, w), 0, k,
                                b, warps, slots, norm_bar);
    for (int i = 0; i < nrows; ++i) {
      const int64_t row = row0 + i;
      const int s = i % p.stages;
      const bool on = row_on<kGated>(p, row);
      if (i + 1 < nrows)
        send_partial(window_sq<kPairs, kGated>(p, ring, full, i + 1, row0, col0, w), i + 1, k, b,
                     warps, slots, norm_bar);
      if (kMode != kNone && on) {  // the row's noise, fetched or drawn while the partials travel
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int q = t + j * nt;
          float2 n = make_float2(0.0f, 0.0f);
          if (q < npairs) {
            if (kMode == kOperand) {
              const float* src = p.noise + row * p.d + col0 + 2 * q;
              n.x = src[0];
              if (2 * q + 1 < w) n.y = src[1];
            } else {
              const float2 z = normal_pair(p.seed, row_key<kGated>(p, row), pair0 + q);
              n = make_float2(__fmul_rn(p.sigma, z.x), __fmul_rn(p.sigma, z.y));
            }
          }
          nz[2 * j] = n.x;
          nz[2 * j + 1] = n.y;
        }
      }
      const float norm = receive_norm(i, k, warps, nrows, slots, norm_bar);
      const float scale = fminf(1.0f, clip_of(p) / sqrtf(fmaxf(norm, kEps)));
      if (b == 0 && t == 0 && on) clip_sq += norm * (scale * scale);
      const int off = misalignment(p, row, col0);
      const float* x = ring + s * p.slot_floats + off;
      if (!on) {
        // a gated-off row adds nothing: its stage holds no copy of it
      } else if ((off & 1) == 0 && npairs == kPairs * nt && (w & 1) == 0) {  // the whole window
        const float2* x2 = reinterpret_cast<const float2*>(x);
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const float2 u = x2[t + j * nt];
          release_pair<kMode>(u, scale, true, nz[2 * j], nz[2 * j + 1], acc[2 * j],
                              acc[2 * j + 1], sq);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int q = t + j * nt;
          if (q < npairs)
            release_pair<kMode>(load_pair(x, q, w, (off & 1) == 0), scale, 2 * q + 1 < w,
                                nz[2 * j], nz[2 * j + 1], acc[2 * j], acc[2 * j + 1], sq);
        }
      }
      // the last warp done with this stage refills it with row i + stages
      __syncwarp();
      if (w > 0 && lane == 0 && atomicAdd(&stage_done[s], 1) == warps - 1) {
        stage_done[s] = 0;
        if (i + p.stages < nrows)
          issue_row<kGated>(p, row + p.stages, col0, w, ring + s * p.slot_floats, &full[s]);
      }
    }
    float* dst = p.colpart + c * p.d + col0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int q = t + j * nt;
      if (q < npairs) {
        dst[2 * q] = acc[2 * j];
        if (2 * q + 1 < w) dst[2 * q + 1] = acc[2 * j + 1];
      }
    }
  } else {
    float* accg = p.colpart + c * p.d + col0;  // this block's window of the cluster's sums
    for (int q = t; q < npairs; q += nt) {      // each thread owns its pairs' two columns
      accg[2 * q] = 0.0f;
      if (2 * q + 1 < w) accg[2 * q + 1] = 0.0f;
    }
    for (int i = 0; i < nrows; ++i) {
      const int64_t row = row0 + i;
      const float* x = p.u + row * p.d + col0;
      const bool on = row_on<kGated>(p, row);  // a gated-off row is not read
      float part = 0.0f;
      if (on)
        for (int j = t; j < w; j += nt) part = fmaf(x[j], x[j], part);
      send_partial(part, i, k, b, warps, slots, norm_bar);
      const float norm = receive_norm(i, k, warps, nrows, slots, norm_bar);
      if (!on) continue;
      const float scale = fminf(1.0f, clip_of(p) / sqrtf(fmaxf(norm, kEps)));
      if (b == 0 && t == 0) clip_sq += norm * (scale * scale);
      for (int q = t; q < npairs; q += nt) {  // second read of the window: from L2
        const bool odd = 2 * q + 1 < w;
        float v0 = __fmul_rn(x[2 * q], scale);
        float v1 = odd ? __fmul_rn(x[2 * q + 1], scale) : 0.0f;
        if (kMode == kOperand) {
          const float* src = p.noise + row * p.d + col0 + 2 * q;
          v0 = __fadd_rn(v0, src[0]);
          if (odd) v1 = __fadd_rn(v1, src[1]);
        } else if (kMode == kFused) {
          const float2 z = normal_pair(p.seed, row_key<kGated>(p, row), pair0 + q);
          v0 = __fadd_rn(v0, __fmul_rn(p.sigma, z.x));
          if (odd) v1 = __fadd_rn(v1, __fmul_rn(p.sigma, z.y));
        }
        if (kMode != kNone) {
          sq = fmaf(v0, v0, sq);
          sq = fmaf(v1, v1, sq);
        }
        accg[2 * q] += v0;
        if (odd) accg[2 * q + 1] += v1;
      }
    }
  }
  // no block leaves while a peer may still reach into its shared memory
  cluster.sync();

  // Partials out; the last block of each window sums it over the clusters.
  if (kMode != kNone) {
    sq = warp_allsum(sq);
    if (lane == 0) warp_part[t >> 5] = sq;
    __syncthreads();
    if (t == 0) {
      float total = 0.0f;
      for (int w2 = 0; w2 < warps; ++w2) total += warp_part[w2];
      p.sqpart[c * k + b] = total;
    }
  }
  if (b == 0 && t == 0) p.clippart[c] = clip_sq;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&p.tickets[b], 1) == clusters - 1;
  __syncthreads();
  if (!last) return;
  if (t == 0) p.tickets[b] = 0;
  constexpr int kCols = 8;  // columns a thread sums at once, for loads in flight
  for (int j0 = t; j0 < w; j0 += kCols * nt) {
    float s[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) s[u] = 0.0f;
    for (int cc = 0; cc < clusters; ++cc) {
      const float* src = p.colpart + cc * p.d + col0;
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (j0 + u * nt < w) s[u] += __ldcg(src + j0 + u * nt);
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      if (j0 + u * nt < w) p.out[col0 + j0 + u * nt] = s[u];
  }
  if (t == 0 && atomicAdd(&p.tickets[kMaxCluster], 1) == k - 1) {
    p.tickets[kMaxCluster] = 0;
    float cs = 0.0f;
    for (int cc = 0; cc < clusters; ++cc) cs += __ldcg(p.clippart + cc);
    float rs = cs;
    if (kMode != kNone) {
      rs = 0.0f;
      for (int r = 0; r < clusters * k; ++r) rs += __ldcg(p.sqpart + r);
    }
    p.out[p.d] = rs;
    p.out[p.d + 1] = cs;
  }
}

// Noise-only: out[i, j] = sigma * z(seed, key_i, j) with key_i = row_ids[i], or
// row_start + i where row_ids is null; grid (m, tiles of 8 * kNoiseThreads
// columns), four column pairs a thread.
__global__ void __launch_bounds__(kNoiseThreads) noise_kernel(float* __restrict__ out, int64_t d,
                                                              float sigma, uint32_t seed,
                                                              int64_t row_start,
                                                              const int* __restrict__ row_ids) {
  const int64_t i = blockIdx.x;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.y) * kNoiseThreads + threadIdx.x) * (2 * kNoisePairs);
  if (c0 >= d) return;
  const uint32_t row = static_cast<uint32_t>(row_ids != nullptr ? __ldg(row_ids + i)
                                                                : row_start + i);
  float v[2 * kNoisePairs];
#pragma unroll
  for (int j = 0; j < kNoisePairs; ++j) {
    const float2 z = normal_pair(seed, row, static_cast<uint32_t>((c0 >> 1) + j));
    v[2 * j] = __fmul_rn(sigma, z.x);
    v[2 * j + 1] = __fmul_rn(sigma, z.y);
  }
  float* o = out + i * d + c0;
  if ((d & 3) == 0 && c0 + 2 * kNoisePairs <= d) {  // 16-byte-aligned rows, a whole tile
#pragma unroll
    for (int j = 0; j < kNoisePairs / 2; ++j)
      reinterpret_cast<float4*>(o)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                                    v[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 2 * kNoisePairs; ++j)
      if (c0 + j < d) o[j] = v[j];
  }
}

using AggregateFn = void (*)(Params);

template <int kMode, bool kGated>
AggregateFn aggregate_for(int pairs) {
  switch (pairs) {
    case 0: return aggregate_kernel<kMode, 0, kGated>;
    case 1: return aggregate_kernel<kMode, 1, kGated>;
    case 2: return aggregate_kernel<kMode, 2, kGated>;
    case 4: return aggregate_kernel<kMode, 4, kGated>;
    case 8: return aggregate_kernel<kMode, 8, kGated>;
    case 16: return aggregate_kernel<kMode, 16, kGated>;
    default: return nullptr;
  }
}

template <bool kGated>
AggregateFn aggregate_for(int mode, int pairs) {
  switch (mode) {
    case kNone: return aggregate_for<kNone, kGated>(pairs);
    case kOperand: return aggregate_for<kOperand, kGated>(pairs);
    case kFused: return aggregate_for<kFused, kGated>(pairs);
    default: return nullptr;
  }
}

AggregateFn aggregate_for(int mode, int pairs, bool gated) {
  return gated ? aggregate_for<true>(mode, pairs) : aggregate_for<false>(mode, pairs);
}

cudaLaunchConfig_t cluster_config(int clusters, int cluster, int threads, int smem_bytes,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let the kernel for (mode, pairs, gated) take `bytes` of dynamic shared
// memory.  The limit only ever rises: a smaller shape must not lower it under
// a larger one that launches later.
cudaError_t allow_smem(int mode, int pairs, bool gated, int bytes) {
  static int allowed[2][3][17] = {};
  int& now = allowed[gated][mode][pairs];
  if (bytes <= now) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(aggregate_for(mode, pairs, gated),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) now = bytes;
  return err;
}

bool valid_shape(int pairs, int cluster, int threads, int smem_bytes) {
  return aggregate_for(kNone, pairs, false) != nullptr && (cluster == 1 || cluster == 2 ||
         cluster == 4 || cluster == 8) && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0 && smem_bytes >= 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  The launch goes on `stream`, no call
// synchronises, and the caller owns every buffer: scratch holds
// clusters * (d + cluster + 1) floats, tickets 16 ints that are 0 before the
// first launch on the stream (the kernel leaves them 0), out d + 2 floats
// (sum_released, sq_released, sq_clipped).  C is `clip`, or *clip_at where
// clip_at is not null (a float in device memory).  row_gate (m floats) and
// row_ids (m int32) may each be null; either one non-null launches the gated
// instance.  The shape plan (cluster, window,
// threads, pairs, stages, slot_floats, smem_bytes, clusters, rows_per_cluster)
// comes from ops.py::_launch_plan.  Returns a cudaError_t (0 = cudaSuccess).
extern "C" int dp_aggregate_launch(const float* u, const float* noise, int mode, int64_t m,
                                   int64_t d, float clip, const float* clip_at,
                                   float sigma, uint32_t seed,
                                   int64_t row_start, const float* row_gate, const int* row_ids,
                                   int cluster, int window, int threads,
                                   int pairs, int stages, int slot_floats, int smem_bytes,
                                   int clusters, int64_t rows_per_cluster, float* scratch,
                                   int* tickets, float* out, void* stream) {
  const bool gated = row_gate != nullptr || row_ids != nullptr;
  const AggregateFn kernel = aggregate_for(mode, pairs, gated);
  if (kernel == nullptr || !valid_shape(pairs, cluster, threads, smem_bytes) || clusters < 1 ||
      window % 4 != 0 || static_cast<int64_t>(window) * cluster < d ||
      (pairs > 0 && (stages < 2 || stages > kMaxStages ||
                     2 * pairs * threads < window || slot_floats < window + 8 ||
                     smem_bytes < 4 * slot_floats * stages)) ||
      clusters * rows_per_cluster < m)
    return kBadPlan;
  const cudaError_t err = allow_smem(mode, pairs, gated, smem_bytes);
  if (err != cudaSuccess) return err;
  Params p;
  p.u = u;
  p.noise = noise;
  p.m = m;
  p.d = d;
  p.row_start = row_start;
  p.rows_per_cluster = rows_per_cluster;
  p.clip = clip;
  p.clip_at = clip_at;
  p.row_gate = row_gate;
  p.row_ids = row_ids;
  p.sigma = sigma;
  p.seed = seed;
  p.window = window;
  p.stages = stages;
  p.slot_floats = slot_floats;
  p.colpart = scratch;
  p.sqpart = scratch + static_cast<int64_t>(clusters) * d;
  p.clippart = p.sqpart + static_cast<int64_t>(clusters) * cluster;
  p.tickets = tickets;
  p.out = out;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, cluster, threads, smem_bytes,
                                                static_cast<cudaStream_t>(stream), &attr);
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// How many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; for the ungated instance, on
// which the gated one's plan is the same.
extern "C" int dp_aggregate_max_clusters(int mode, int pairs, int cluster, int threads,
                                         int smem_bytes, int* out) {
  const AggregateFn kernel = aggregate_for(mode, pairs, false);
  if (kernel == nullptr || !valid_shape(pairs, cluster, threads, smem_bytes))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mode, pairs, false, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, threads, smem_bytes, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// Registers, local (spill) bytes and static shared memory of the aggregation
// kernel for (mode, pairs, gated), or of the noise-only kernel for mode -1.
extern "C" int dp_aggregate_attributes(int mode, int pairs, int gated, int* regs,
                                       int* local_bytes, int* static_smem) {
  const void* kernel = mode < 0 ? reinterpret_cast<const void*>(noise_kernel)
                                : reinterpret_cast<const void*>(aggregate_for(mode, pairs,
                                                                              gated != 0));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  return cudaSuccess;
}

extern "C" const char* dp_aggregate_error_name(int err) {
  return err == kBadPlan ? "a launch plan the kernel does not take"
                         : cudaGetErrorName(static_cast<cudaError_t>(err));
}

// row_ids: m int32 row keys, or null for row_start + i.
extern "C" int ldp_noise_launch(float* out, int64_t m, int64_t d, float sigma, uint32_t seed,
                                int64_t row_start, const int* row_ids, void* stream) {
  const int64_t tile = 2 * kNoisePairs * kNoiseThreads;
  const int64_t tiles = (d + tile - 1) / tile;
  if (m < 1 || d < 1 || m > 0x7fffffff || tiles > 65535) return cudaErrorInvalidValue;
  noise_kernel<<<dim3(static_cast<unsigned>(m), static_cast<unsigned>(tiles)), kNoiseThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(out, d, sigma, seed, row_start, row_ids);
  return cudaGetLastError();
}
