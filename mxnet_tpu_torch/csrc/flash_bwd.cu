// Flash-attention backward, dK/dV, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_bwd_dkv_kernel
// (mxnet_tpu/ops/pallas_kernels.py:529-584), launched there by
// _flash_bwd_tpu (:638-740), in its plain and segment-id forms. The dQ
// half of the backward is flash_bwd_dq.cu.
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
//   dV_j    = sum_i p_ij g_i,   dK_j = sum_i ds_ij q_i
// p is forced to 0 under the COMBINED mask, never computed and then masked:
// a fully masked row stores lse = -1e30 (exactly, in fp32), and exp(s - lse)
// of a hidden score is then 1 or inf, not 0 (the reference masks p for the
// same reason, :565-568).
//
// No atomics, as the reference: each block owns kRows keys and loops over
// all query tiles that can see them. Every gradient row is summed by one
// thread group in a fixed order, so the result is deterministic from run to
// run.
//
// What bounds it on this card: per visible (query, key) pair the kernel
// does 8*D FLOPs (s, dp, dV, dK), while each operand row is read from
// device memory once per kRows-row block: at GPT-2 training shapes
// (D = 64, T = 1024) it is bound by arithmetic. This version does it in
// fp32 on the CUDA cores (67 TFLOP/s peak), not on the tensor cores
// (ROADMAP B2). What the design does about it: the query tile that the loop
// walks is staged once per block in shared memory as fp32 and reused by all
// kRows keys the block owns; each key belongs to a quad of 4 threads that
// keep their slices of the key's operands and fp32 accumulators in
// registers and read the staged tile as 16-byte float4 chunks, so one
// shared-memory load feeds four FMAs of each of two products, and the 8
// quads of a warp read one address (a broadcast, no bank conflict); the two
// dot products of a pair share one pass over the chunks and are summed
// across the quad by two shuffles each; causal blocks skip the tiles that
// no key of theirs can see.
//
// Tiles are call parameters (the tuner picks them, ROADMAP B's rule): the
// block owns kRows = block_k keys and stages kTile = block_q queries at a
// time, each from {16, 32, 64}; (32, 32) is the default. The staged tiles
// live in dynamic shared memory (64 KiB at a 64-row tile and D = 128, over
// the 48 KiB static limit).
#include <math.h>

#include "common.cuh"

namespace {

using mxtt::from_f32;
using mxtt::to_f32;

constexpr int kGroup = 4;  // threads per owned row

// Dynamic shared memory of one block: two staged fp32 tiles plus three
// per-row words (lse, delta, segment id).
template <int kTile, int kDPad>
constexpr size_t smem_bytes() {
  return 2 * sizeof(float) * kTile * kDPad + 3 * sizeof(float) * kTile;
}

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
template <typename T, int kDPad, int kTile, int kThreads>
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

// dK, dV: one block per (kRows keys, bh); loops over kTile-query tiles.
// V float4 chunks per thread: head dims up to 16 * V.
template <typename T, int V, int kRows, int kTile>
__global__ void __launch_bounds__(kRows * kGroup)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int Tk, int D,
                         float scale, int causal) {
  constexpr int kDPad = 16 * V;
  constexpr int kThreads = kRows * kGroup;
  extern __shared__ float4 smem[];
  float4(*q_s)[kDPad / 4] = reinterpret_cast<float4(*)[kDPad / 4]>(smem);
  float4(*g_s)[kDPad / 4] =
      reinterpret_cast<float4(*)[kDPad / 4]>(smem + kTile * kDPad / 4);
  float* lse_s = reinterpret_cast<float*>(smem + 2 * kTile * kDPad / 4);
  float* dl_s = lse_s + kTile;
  int* qs_s = reinterpret_cast<int*>(dl_s + kTile);

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
    stage_tile<T, kDPad, kTile, kThreads>(
        qbase, gbase, qb, Tq, D, reinterpret_cast<float*>(&q_s[0][0]),
        reinterpret_cast<float*>(&g_s[0][0]), tid);
    for (int ii = tid; ii < kTile; ii += kThreads) {
      const int i = qb + ii;
      const bool in = i < Tq;
      const size_t r = (size_t)bh * Tq + i;
      lse_s[ii] = in ? lse[r] : 0.f;
      dl_s[ii] = in ? delta[r] : 0.f;
      qs_s[ii] = (use_seg && in) ? qseg[(size_t)b * Tq + i] : 0;
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

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int *qseg, *kseg;
  void *dk, *dv;
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
};

// kRows: the keys a block owns; kTile: the query tile.
template <typename T, int V, int kRows, int kTile>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, V, kRows, kTile>;
  constexpr size_t kSmem = smem_bytes<kTile, 16 * V>();
  if (kSmem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((a.Tk + kRows - 1) / kRows, a.BH);
  kernel<<<grid, kRows * kGroup, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.qseg, a.kseg, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Tq, a.Tk, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int V, int kRows>
cudaError_t dispatch_tile(const Args& a, int tile, cudaStream_t s) {
  switch (tile) {
    case 16: return launch<T, V, kRows, 16>(a, s);
    case 32: return launch<T, V, kRows, 32>(a, s);
    case 64: return launch<T, V, kRows, 64>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t dispatch_rows(const Args& a, int rows, int tile,
                          cudaStream_t s) {
  switch (rows) {
    case 16: return dispatch_tile<T, V, 16>(a, tile, s);
    case 32: return dispatch_tile<T, V, 32>(a, tile, s);
    case 64: return dispatch_tile<T, V, 64>(a, tile, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int rows, int tile, cudaStream_t s) {
  if (a.D <= 16) return dispatch_rows<T, 1>(a, rows, tile, s);
  if (a.D <= 32) return dispatch_rows<T, 2>(a, rows, tile, s);
  if (a.D <= 64) return dispatch_rows<T, 4>(a, rows, tile, s);
  if (a.D <= 128) return dispatch_rows<T, 8>(a, rows, tile, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, g (BH, Tq, D); k, v (BH, Tk, D), contiguous and of one dtype; float32
// lse and delta (BH, Tq); qseg (BH / H, Tq) and kseg (BH / H, Tk) int32, or
// both null; dk, dv (BH, Tk, D) in the operands' dtype; the tile block_q,
// block_k, each 16, 32 or 64 (the block owns block_k keys and stages
// block_q queries at a time). Launches one kernel on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const float* lse,
                                  const float* delta, const int* qseg,
                                  const int* kseg, void* dk, void* dv, int BH,
                                  int H, int Tq, int Tk, int D, float scale,
                                  int causal, int dtype, int block_q,
                                  int block_k, void* stream) {
  if (BH < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || BH % H != 0 ||
      BH > 65535 || (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, delta, qseg, kseg, dk, dv,
               BH, H, Tq, Tk, D, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxtt::kFloat32) return dispatch_d<float>(a, block_k, block_q, s);
  if (dtype == mxtt::kBFloat16)
    return dispatch_d<__nv_bfloat16>(a, block_k, block_q, s);
  return cudaErrorInvalidValue;
}
