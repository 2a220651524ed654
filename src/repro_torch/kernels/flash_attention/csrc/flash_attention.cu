// Flash (online-softmax) attention forward for Hopper (sm_90a):
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//
// over the keys j visible to query i: j < kv_len, and j <= i when causal, and
// j > i - window when a window is set.  q is (B, Hq, Sq, Dh), k and v are
// (B, Hkv, Skv, Dh) with Hq = group * Hkv (GQA; MQA at Hkv = 1), each with
// any (batch, head, row) strides and a contiguous last axis.  float32 or
// bfloat16 in; the output has q's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_kernel`, launched by `flash_attention_kernel_call`).  It computes what
// that kernel computes: q scaled by 1/sqrt(Dh) (or the given scale) in
// float32, scores masked with -1e30, float32 running max, denominator and
// accumulator, and o = acc / max(l, 1e-30) cast to q's type.  One departure:
// the probability of a masked key is set to 0 explicitly, so a query row with
// no visible key at all gives 0 (the TPU kernel gives there the mean of v over
// the masked keys of the tiles it visited).  A causal prefill has no such row.
//
// What bounds it on the card.  The least work is 4 * Dh operations per visible
// (query, key) pair (two products, a multiply and an add each), and the bytes
// are q, k, v and o once each.  At the serve shape (B 2, Hq 32, Hkv 8, S 8192,
// Dh 120, window 4096) that is 7.7e11 operations, 0.78 ms at 989 TFLOP/s bf16,
// against 0.04 ms for the bytes: it is bound by operations.  This first kernel
// does its products on the float32 pipes (67 TFLOP/s), not on the tensor cores,
// so it sits far above that bound.  The dispatch now sends it float32 only:
// bf16 at any Dh up to 256 goes to csrc/flash_attention_tc.cu (TMA and wgmma);
// bf16 here is what simt_kernel takes when called by name.
//
// Design, and where it departs from the TPU kernel:
// * The TPU grid (B*Hq, Sq/bq, Skv/bk) carries the key-tile axis in order,
//   with the running state in VMEM scratch.  CUDA blocks run in parallel in no
//   order, so one block owns one (batch*head, 64-row query tile) pair and
//   loops over the key tiles itself, with the running state in registers.
// * The causal and window band sets that loop's bounds, so tiles outside the
//   band are never loaded.  The TPU kernel visits every tile and skips the
//   compute of those outside the band with pl.when.
// * Each block writes only its own rows: no atomics, and two launches give
//   identical bits.
// * Any Dh up to 256: each thread owns output columns tx, tx+16, ... (NC of
//   them, a template parameter), and the pad columns of the V tile are zero.
//   Nothing is padded in device memory; ragged Sq, Skv and kv_len are masked
//   by bounds.  At Dh 256 the float32 tiles take 213 KiB of shared memory,
//   which needs dynamic shared memory and cudaFuncSetAttribute.
// * Thread layout: 256 threads as 16 row groups (ty) x 16 column lanes (tx).
//   Thread (ty, tx) holds scores of rows 4ty..4ty+3 and keys tx+16j (j < 4),
//   so the 16 threads of a row sit in one half-warp and reduce the row max
//   and sum with shuffles.  Shared tiles: Qt[d][r] (q transposed, scaled),
//   Ks[c][d] with an odd row stride (column reads free of bank conflicts),
//   Vs[c][d], and Pt[c][r] (probabilities transposed, read as float4).
// * Build without --use_fast_math: expf and the division round as the plain
//   version's float32 ops do.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLdRows = kBlockQ + 4;  // row stride of Qt and Pt: float4-aligned
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// floats of dynamic shared memory for head dim `dh` and NC columns per thread
__host__ __device__ constexpr int smem_floats(int dh, int nc) {
  return dh * kLdRows + kBlockK * (dh | 1) + kBlockK * 16 * nc + kBlockK * kLdRows;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int group, int sq, int skv, int dh, int kv_len,
                 float scale, int causal, int window, Strides qs, Strides ks, Strides vs,
                 Strides os) {
  extern __shared__ float4 smem4[];
  const int ldk = dh | 1;   // odd: the 16 lanes reading one column hit 16 banks
  const int ldv = 16 * NC;  // the threads' columns; pad columns hold 0
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + dh * kLdRows;
  float* Vs = Ks + kBlockK * ldk;
  float* Pt = Vs + kBlockK * ldv;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int r = warp; r < kBlockQ; r += kThreads / 32) {
    const int qi = q0 + r;
    for (int d = lane; d < dh; d += 32)
      Qt[d * kLdRows + r] = qi < sq ? to_float(qb[qi * qs.s + d]) * scale : 0.f;
  }

  // the band of keys any row of this tile can see
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_hi = causal ? min(kv_len, q_last + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBlockK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBlockK - 1) / kBlockK : t_lo;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // Qt written; the last tile's Ks, Vs and Pt read
    for (int c = warp; c < kBlockK; c += kThreads / 32) {
      const int kj = k0 + c;
      const bool in = kj < skv;
      for (int d = lane; d < dh; d += 32) Ks[c * ldk + d] = in ? to_float(kb[kj * ks.s + d]) : 0.f;
      for (int d = lane; d < ldv; d += 32)
        Vs[c * ldv + d] = in && d < dh ? to_float(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kLdRows + ty * 4]);
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(qv.x, kv[j], s[0][j]);
        s[1][j] = fmaf(qv.y, kv[j], s[1][j]);
        s[2][j] = fmaf(qv.z, kv[j], s[2][j]);
        s[3][j] = fmaf(qv.w, kv[j], s[3][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool vis[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        vis[j] = kj < kv_len && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
        s[i][j] = vis[j] ? s[i][j] : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_sum += s[i][j];
      }
      l[i] = alpha * l[i] + p_sum;  // this thread's share; summed over the row at the end
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * kLdRows + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int c_end = min(kBlockK, k_hi - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c * kLdRows + ty * 4]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = Vs[c * ldv + tx + 16 * n];
        acc[0][n] = fmaf(pv.x, vv, acc[0][n]);
        acc[1][n] = fmaf(pv.y, vv, acc[1][n]);
        acc[2][n] = fmaf(pv.z, vv, acc[2][n]);
        acc[3][n] = fmaf(pv.w, vv, acc[3][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l_row = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l_row += __shfl_xor_sync(0xffffffffu, l_row, off);
    l_row = fmaxf(l_row, 1e-30f);
    const int qi = q0 + ty * 4 + i;
    if (qi < sq) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int d = tx + 16 * n;
        if (d < dh) ob[qi * os.s + d] = from_float<T>(acc[i][n] / l_row);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, hq, hkv, sq, skv, dh, kv_len, causal, window;
  float scale;
  Strides qs, ks, vs, os;
};

template <typename T, int NC>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = smem_floats(a.dh, NC) * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.batch * a.hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.hq, a.hq / a.hkv, a.sq, a.skv, a.dh, a.kv_len, a.scale, a.causal,
      a.window, a.qs, a.ks, a.vs, a.os);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.dh <= 64) return launch<T, 4>(a, stream);
  if (a.dh <= 128) return launch<T, 8>(a, stream);
  if (a.dh <= 192) return launch<T, 12>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  Strides in elements,
// (batch, head, row) of q, k, v and o.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int batch, int hq, int hkv, int sq, int skv,
                                      int dh, int kv_len, float scale, int causal, int window,
                                      int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                      int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                      int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                                      void* stream) {
  if (dh < 1 || dh > 256 || hkv < 1 || hq % hkv != 0 || batch * hq > 65535 || sq < 1)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, batch, hq, hkv, sq, skv, dh, kv_len, causal, window, scale,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(a, s);
    case 1:
      return dispatch<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
