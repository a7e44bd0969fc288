// Flash-attention backward, written by hand for Hopper (sm_90a): two
// kernels, one for dK/dV and one for dQ.
//
// Replaces the Pallas TPU kernels _flash_bwd_dkv_kernel
// (mxnet_tpu/ops/pallas_kernels.py:529-584) and _flash_bwd_dq_kernel
// (:587-635), both launched there by _flash_bwd_tpu (:638-740), in their
// plain and segment-id forms.
//
// With the forward's fp32 log-sum-exp lse_i and Delta_i = sum_d g_id o_id
// (fp32, computed by the caller as the reference does at :647-648), for each
// fused batch-head bh (batch b = bh / H), query i and key j:
//   s_ij    = (q_i . k_j) * scale                                    fp32
//   visible = i < Tq && j < Tk        (the ragged edges, masked here: no
//                                      padding wrapper exists)
//           && (!causal || j <= i + (Tk - Tq))             (bottom-right)
//           && (!seg    || qseg[b, i] == kseg[b, j])
//   p_ij    = visible ? exp(s_ij - lse_i) : 0
//   dp_ij   = g_i . v_j
//   ds_ij   = p_ij (dp_ij - Delta_i) * scale
//   dV_j    = sum_i p_ij g_i,   dK_j = sum_i ds_ij q_i,   dQ_i = sum_j ds_ij k_j
// p is forced to 0 under the COMBINED mask, never computed and then masked:
// a fully masked row stores lse = -1e30 (exactly, in fp32), and exp(s - lse)
// of a hidden score is then 1 or inf, not 0 (the reference masks p for the
// same reason, :565-568 and :623-624).
//
// Two kernels and no atomics, as the reference: flash_bwd_dkv_kernel gives
// each block 32 keys and loops over all query tiles that can see them;
// flash_bwd_dq_kernel gives each block 32 queries and loops over key tiles.
// Every gradient row is summed by one thread group in a fixed order, so the
// result is deterministic from run to run.
//
// What bounds it on this card: per visible (query, key) pair the dK/dV
// kernel does 8*D FLOPs (s, dp, dV, dK) and the dQ kernel 6*D (s, dp, dQ),
// while each operand row is read from device memory once per 32-row tile:
// at GPT-2 training shapes (D = 64, T = 1024) both are bound by arithmetic.
// This first version does it in fp32 on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores (no wgmma or TMA yet: later work). What the design
// does about it: the tile that the loop walks is staged once per block in
// shared memory as fp32 and reused by all 32 rows the block owns; each row
// belongs to a quad of 4 threads that keep their slices of the row's
// operands and fp32 accumulators in registers and read the staged tile as
// 16-byte float4 chunks, so one shared-memory load feeds four FMAs of each
// of two products, and the 8 quads of a warp read one address (a broadcast,
// no bank conflict); the two dot products of a pair share one pass over
// the chunks and are summed across the quad by two shuffles each; causal
// blocks skip the tiles that no row of theirs can see.
#include <math.h>

#include "common.cuh"

namespace {

using mxtt::from_f32;
using mxtt::to_f32;

constexpr int kGroup = 4;                  // threads per owned row
constexpr int kRows = 32;                  // owned rows per block
constexpr int kThreads = kRows * kGroup;   // 128
constexpr int kTile = 32;                  // rows of a shared-memory tile

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float dot4(const float* r, float4 c) {
  return r[0] * c.x + r[1] * c.y + r[2] * c.z + r[3] * c.w;
}

__device__ __forceinline__ void axpy4(float* acc, float a, float4 c) {
  acc[0] += a * c.x;
  acc[1] += a * c.y;
  acc[2] += a * c.z;
  acc[3] += a * c.w;
}

// Row ``row`` (or zeros when !ok) of a (rows, D) operand as this thread's
// fp32 slice: dims 4c..4c+3 for the chunks c = t + 4i.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* base, int row, bool ok,
                                         int D, int t, float* r) {
  const T* p = base + (size_t)(ok ? row : 0) * D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 4 * (t + kGroup * i) + u;
      r[4 * i + u] = (ok && d < D) ? to_f32(p[d]) : 0.f;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* base, int row, int D, int t,
                                          const float* r) {
  T* p = base + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 4 * (t + kGroup * i) + u;
      if (d < D) p[d] = from_f32<T>(r[4 * i + u]);
    }
  }
}

// Stage rows r0 .. r0+kTile-1 of two (rows, D) operands into shared memory
// as fp32, zero past ``rows`` and past D.
template <typename T, int kDPad>
__device__ __forceinline__ void stage_tile(const T* a, const T* b, int r0,
                                           int rows, int D, float* as,
                                           float* bs, int tid) {
  for (int idx = tid; idx < kTile * kDPad; idx += kThreads) {
    const int r = r0 + idx / kDPad;
    const int d = idx % kDPad;
    const bool in = r < rows && d < D;
    const size_t off = (size_t)r * D + d;
    as[idx] = in ? to_f32(a[off]) : 0.f;
    bs[idx] = in ? to_f32(b[off]) : 0.f;
  }
}

// dK, dV: one block per (32 keys, bh); loops over query tiles.
// V float4 chunks per thread: head dims up to 16 * V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int Tk, int D,
                         float scale, int causal) {
  constexpr int kDPad = 16 * V;
  __shared__ float4 q_s[kTile][kDPad / 4];
  __shared__ float4 g_s[kTile][kDPad / 4];
  __shared__ float lse_s[kTile];
  __shared__ float dl_s[kTile];
  __shared__ int qs_s[kTile];

  const int tid = threadIdx.x;
  const int t = tid % kGroup;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kRows;
  const int kj = k0 + tid / kGroup;
  const bool row_ok = kj < Tk;
  const bool use_seg = qseg != nullptr;
  const int offset = Tk - Tq;

  float kr[4 * V], vr[4 * V], dka[4 * V], dva[4 * V];
  load_row<T, V>(k + (size_t)bh * Tk * D, kj, row_ok, D, t, kr);
  load_row<T, V>(v + (size_t)bh * Tk * D, kj, row_ok, D, t, vr);
#pragma unroll
  for (int e = 0; e < 4 * V; ++e) dka[e] = dva[e] = 0.f;
  const int ks = (use_seg && row_ok) ? kseg[(size_t)b * Tk + kj] : 0;

  // under causal, query i sees key j iff i >= j - offset: the block's first
  // key bounds the first query tile that matters
  const int qbeg = causal ? max(k0 - offset, 0) : 0;
  const T* qbase = q + (size_t)bh * Tq * D;
  const T* gbase = g + (size_t)bh * Tq * D;
  for (int qb = qbeg; qb < Tq; qb += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<T, kDPad>(qbase, gbase, qb, Tq, D,
                         reinterpret_cast<float*>(&q_s[0][0]),
                         reinterpret_cast<float*>(&g_s[0][0]), tid);
    if (tid < kTile) {
      const int i = qb + tid;
      const bool in = i < Tq;
      const size_t r = (size_t)bh * Tq + i;
      lse_s[tid] = in ? lse[r] : 0.f;
      dl_s[tid] = in ? delta[r] : 0.f;
      qs_s[tid] = (use_seg && in) ? qseg[(size_t)b * Tq + i] : 0;
    }
    __syncthreads();

#pragma unroll 2
    for (int ii = 0; ii < kTile; ++ii) {
      const int i = qb + ii;
      float4 qc[V], gc[V];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        qc[c] = q_s[ii][t + kGroup * c];
        gc[c] = g_s[ii][t + kGroup * c];
        s += dot4(kr + 4 * c, qc[c]);
        dp += dot4(vr + 4 * c, gc[c]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      bool ok = row_ok && i < Tq;
      if (causal) ok = ok && kj <= i + offset;
      if (use_seg) ok = ok && qs_s[ii] == ks;
      const float p = ok ? expf(s * scale - lse_s[ii]) : 0.f;
      const float ds = p * (dp - dl_s[ii]) * scale;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        axpy4(dva + 4 * c, p, gc[c]);
        axpy4(dka + 4 * c, ds, qc[c]);
      }
    }
  }

  if (row_ok) {
    store_row<T, V>(dk + (size_t)bh * Tk * D, kj, D, t, dka);
    store_row<T, V>(dv + (size_t)bh * Tk * D, kj, D, t, dva);
  }
}

// dQ: one block per (32 queries, bh); loops over key tiles.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, T* __restrict__ dq,
                        int H, int Tq, int Tk, int D, float scale,
                        int causal) {
  constexpr int kDPad = 16 * V;
  __shared__ float4 k_s[kTile][kDPad / 4];
  __shared__ float4 v_s[kTile][kDPad / 4];
  __shared__ int ks_s[kTile];

  const int tid = threadIdx.x;
  const int t = tid % kGroup;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + tid / kGroup;
  const bool row_ok = qi < Tq;
  const bool use_seg = qseg != nullptr;
  const int offset = Tk - Tq;

  float qr[4 * V], gr[4 * V], dqa[4 * V];
  load_row<T, V>(q + (size_t)bh * Tq * D, qi, row_ok, D, t, qr);
  load_row<T, V>(g + (size_t)bh * Tq * D, qi, row_ok, D, t, gr);
#pragma unroll
  for (int e = 0; e < 4 * V; ++e) dqa[e] = 0.f;
  const size_t r = (size_t)bh * Tq + (row_ok ? qi : 0);
  const float lse_i = row_ok ? lse[r] : 0.f;
  const float dl_i = row_ok ? delta[r] : 0.f;
  const int qs = (use_seg && row_ok) ? qseg[(size_t)b * Tq + qi] : 0;

  // a causal block stops at the last key its last row can see
  int kend = Tk;
  if (causal) {
    const int q_last = min(q0 + kRows, Tq) - 1;
    kend = min(Tk, max(q_last + offset + 1, 0));
  }
  const T* kbase = k + (size_t)bh * Tk * D;
  const T* vbase = v + (size_t)bh * Tk * D;
  for (int kb = 0; kb < kend; kb += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    stage_tile<T, kDPad>(kbase, vbase, kb, Tk, D,
                         reinterpret_cast<float*>(&k_s[0][0]),
                         reinterpret_cast<float*>(&v_s[0][0]), tid);
    if (tid < kTile) {
      const int j = kb + tid;
      ks_s[tid] = (use_seg && j < Tk) ? kseg[(size_t)b * Tk + j] : 0;
    }
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = kb + jj;
      float4 kc[V];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        kc[c] = k_s[jj][t + kGroup * c];
        s += dot4(qr + 4 * c, kc[c]);
        dp += dot4(gr + 4 * c, v_s[jj][t + kGroup * c]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      bool ok = row_ok && j < Tk;
      if (causal) ok = ok && j <= qi + offset;
      if (use_seg) ok = ok && ks_s[jj] == qs;
      const float p = ok ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - dl_i) * scale;
#pragma unroll
      for (int c = 0; c < V; ++c) axpy4(dqa + 4 * c, ds, kc[c]);
    }
  }

  if (row_ok) store_row<T, V>(dq + (size_t)bh * Tq * D, qi, D, t, dqa);
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int *qseg, *kseg;
  void *out0, *out1;  // dk, dv for the dK/dV kernel; dq, unused for dQ
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
};

template <typename T, int V>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.BH);
  flash_bwd_dkv_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.qseg, a.kseg, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H,
      a.Tq, a.Tk, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.BH);
  flash_bwd_dq_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.qseg, a.kseg, static_cast<T*>(a.out0), a.H, a.Tq, a.Tk, a.D,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDKV, typename T, int V>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if constexpr (kDKV) {
    return launch_dkv<T, V>(a, s);
  } else {
    return launch_dq<T, V>(a, s);
  }
}

template <bool kDKV, typename T>
cudaError_t dispatch_d(const Args& a, cudaStream_t s) {
  if (a.D <= 16) return launch<kDKV, T, 1>(a, s);
  if (a.D <= 32) return launch<kDKV, T, 2>(a, s);
  if (a.D <= 64) return launch<kDKV, T, 4>(a, s);
  if (a.D <= 128) return launch<kDKV, T, 8>(a, s);
  return cudaErrorInvalidValue;
}

template <bool kDKV>
int dispatch(const Args& a, int dtype, void* stream) {
  if (a.BH < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1 || a.D < 1 ||
      a.BH % a.H != 0 || a.BH > 65535 ||
      (a.qseg == nullptr) != (a.kseg == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxtt::kFloat32) return dispatch_d<kDKV, float>(a, s);
  if (dtype == mxtt::kBFloat16) return dispatch_d<kDKV, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both entry points take, contiguous and of one dtype: q, g (BH, Tq, D);
// k, v (BH, Tk, D); float32 lse and delta (BH, Tq); qseg (BH / H, Tq) and
// kseg (BH / H, Tk) int32, or both null. Each launches one kernel on
// ``stream`` and returns cudaGetLastError() (0 on success).

// dk, dv: (BH, Tk, D) in the operands' dtype.
extern "C" int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const float* lse,
                                  const float* delta, const int* qseg,
                                  const int* kseg, void* dk, void* dv, int BH,
                                  int H, int Tq, int Tk, int D, float scale,
                                  int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, qseg, kseg, dk, dv,
               BH, H, Tq, Tk, D, scale, causal};
  return dispatch<true>(a, dtype, stream);
}

// dq: (BH, Tq, D) in the operands' dtype.
extern "C" int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const float* lse,
                                 const float* delta, const int* qseg,
                                 const int* kseg, void* dq, int BH, int H,
                                 int Tq, int Tk, int D, float scale,
                                 int causal, int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, qseg, kseg, dq, nullptr,
               BH, H, Tq, Tk, D, scale, causal};
  return dispatch<false>(a, dtype, stream);
}
