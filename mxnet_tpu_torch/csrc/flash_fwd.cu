// Flash-attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (mxnet_tpu/ops/pallas_kernels.py:163-224), launched there by
// _flash_attention_tpu (:236-297), in both its plain and segment-id forms.
//
// For each fused batch-head bh (batch b = bh / H) and query row i:
//   s_ij      = (q_i . k_j) * scale                                  fp32
//   visible   = j < Tk                      (the ragged edge is excluded,
//                                            never zero-filled: a zero key
//                                            scores 0 and would count)
//             && (!causal || j <= i + (Tk - Tq))       (bottom-right)
//             && (!seg    || qseg[b, i] == kseg[b, j])
//   out_i     = sum_j p_ij v_j / max(l_i, 1e-30),   p zeroed where hidden
//   lse_i     = m_i + log(max(l_i, 1e-30))
// with an online softmax over key tiles: fp32 running max m, sum l and
// accumulator per row. A row that sees no key emits zeros.
//
// What bounds it on this card: at GPT-2 prefill shapes (D = 64, T up to
// 1024) the kernel does 4*D FLOPs per visible (query, key) pair and reads
// each K/V row once per block of kRows queries, so it is bound by
// arithmetic, not by device memory. This first version does the arithmetic
// in fp32 on the CUDA cores (67 TFLOP/s peak), not on the tensor cores (no
// wgmma or TMA yet: that is later work). What the design does about it: K/V
// tiles are staged once per block in shared memory and reused by all kRows
// query rows; each row belongs to a quad of 4 threads that read 16-byte
// float4 chunks, so one shared-memory load feeds four FMAs and the 8 quads
// of a warp read one address (a broadcast, no bank conflict); a tile's
// scores stay in registers; a causal block stops at the last key any of its
// rows can see.
//
// Tiles are call parameters (the tuner picks them, ROADMAP B's rule):
// kRows = block_q query rows a block and kBlockK = block_k keys a
// shared-memory tile, each from {16, 32, 64}; (32, 32) is the default.
// The K/V tiles live in dynamic shared memory: at block_k = 64 and
// D = 128 they take 64 KiB, over the 48 KiB static limit.
#include <math.h>

#include "common.cuh"

namespace {

using mxtt::from_f32;
using mxtt::to_f32;

constexpr int kGroup = 4;  // threads per query row

// Dynamic shared memory of one block: the K and V tiles (fp32) and the
// tile's key segment ids.
template <int kBlockK, int kDPad>
constexpr size_t smem_bytes() {
  return 2 * sizeof(float) * kBlockK * kDPad + sizeof(int) * kBlockK;
}

// V float4 chunks per thread: head dims up to 16 * V. kRows query rows a
// block (kRows * 4 threads), kBlockK keys a shared-memory tile.
template <typename T, int V, int kRows, int kBlockK>
__global__ void __launch_bounds__(kRows * kGroup)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, int D,
                     float scale, int causal) {
  constexpr int kDPad = 16 * V;
  constexpr int kThreads = kRows * kGroup;
  extern __shared__ float4 smem[];
  float4(*k_s)[kDPad / 4] = reinterpret_cast<float4(*)[kDPad / 4]>(smem);
  float4(*v_s)[kDPad / 4] =
      reinterpret_cast<float4(*)[kDPad / 4]>(smem + kBlockK * kDPad / 4);
  int* ks_s = reinterpret_cast<int*>(smem + 2 * kBlockK * kDPad / 4);

  const float kNegInf = __int_as_float(0xff800000);
  const int tid = threadIdx.x;
  const int t = tid % kGroup;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + tid / kGroup;
  const bool row_ok = qi < Tq;
  const bool use_seg = qseg != nullptr;
  const int offset = Tk - Tq;

  // this thread's chunks of the query row: dims 4c..4c+3, c = t + 4i
  float qr[4 * V];
  float acc[4 * V];
  const T* qrow = q + ((size_t)bh * Tq + (row_ok ? qi : 0)) * D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 4 * (t + kGroup * i) + u;
      qr[4 * i + u] = (row_ok && d < D) ? to_f32(qrow[d]) : 0.f;
      acc[4 * i + u] = 0.f;
    }
  }
  const int qs = (use_seg && row_ok) ? qseg[(size_t)b * Tq + qi] : 0;

  int kend = Tk;
  if (causal) {
    const int q_last = min(q0 + kRows, Tq) - 1;
    kend = min(Tk, max(q_last + offset + 1, 0));
  }
  const T* kbase = k + (size_t)bh * Tk * D;
  const T* vbase = v + (size_t)bh * Tk * D;
  float* kf = reinterpret_cast<float*>(&k_s[0][0]);
  float* vf = reinterpret_cast<float*>(&v_s[0][0]);

  float m = -1e30f;  // the reference's finite "-inf": a hidden row keeps it
  float l = 0.f;
  for (int kb = 0; kb < kend; kb += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBlockK * kDPad; idx += kThreads) {
      const int j = idx / kDPad;
      const int d = idx % kDPad;
      const int key = kb + j;
      const bool in = key < Tk && d < D;
      const size_t g = (size_t)key * D + d;
      kf[idx] = in ? to_f32(kbase[g]) : 0.f;
      vf[idx] = in ? to_f32(vbase[g]) : 0.f;
    }
    for (int j = tid; j < kBlockK; j += kThreads) {
      const int key = kb + j;
      ks_s[j] = (use_seg && key < Tk) ? kseg[(size_t)b * Tk + key] : 0;
    }
    __syncthreads();

    float sc[kBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float4 kk = k_s[j][t + kGroup * i];
        part += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y +
                qr[4 * i + 2] * kk.z + qr[4 * i + 3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = kb + j;
      bool ok = key < Tk;
      if (causal) ok = ok && key <= qi + offset;
      if (use_seg) ok = ok && ks_s[j] == qs;
      // hidden keys score -inf: exp() zeroes their p exactly, and the
      // running max never drops below the finite -1e30 it starts from
      sc[j] = ok ? part * scale : kNegInf;
      m_new = fmaxf(m_new, sc[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 4 * V; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
      // the reference multiplies p cast to V's dtype (a no-op in fp32)
      const float pv = to_f32(from_f32<T>(p));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float4 vv = v_s[j][t + kGroup * i];
        acc[4 * i] += pv * vv.x;
        acc[4 * i + 1] += pv * vv.y;
        acc[4 * i + 2] += pv * vv.z;
        acc[4 * i + 3] += pv * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 4 * (t + kGroup * i) + u;
        if (d < D) orow[d] = from_f32<T>(acc[4 * i + u] / denom);
      }
    }
    if (t == 0) lse[(size_t)bh * Tq + qi] = m + logf(denom);
  }
}

struct Args {
  const void *q, *k, *v;
  const int *qseg, *kseg;
  void* out;
  float* lse;
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
};

template <typename T, int V, int kRows, int kBlockK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, V, kRows, kBlockK>;
  constexpr size_t kSmem = smem_bytes<kBlockK, 16 * V>();
  if (kSmem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((a.Tq + kRows - 1) / kRows, a.BH);
  kernel<<<grid, kRows * kGroup, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qseg, a.kseg, static_cast<T*>(a.out),
      a.lse, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int V, int kRows>
cudaError_t dispatch_k(const Args& a, int block_k, cudaStream_t s) {
  switch (block_k) {
    case 16: return launch<T, V, kRows, 16>(a, s);
    case 32: return launch<T, V, kRows, 32>(a, s);
    case 64: return launch<T, V, kRows, 64>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t dispatch_q(const Args& a, int block_q, int block_k,
                       cudaStream_t s) {
  switch (block_q) {
    case 16: return dispatch_k<T, V, 16>(a, block_k, s);
    case 32: return dispatch_k<T, V, 32>(a, block_k, s);
    case 64: return dispatch_k<T, V, 64>(a, block_k, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int block_q, int block_k,
                     cudaStream_t s) {
  if (a.D <= 16) return dispatch_q<T, 1>(a, block_q, block_k, s);
  if (a.D <= 32) return dispatch_q<T, 2>(a, block_q, block_k, s);
  if (a.D <= 64) return dispatch_q<T, 4>(a, block_q, block_k, s);
  if (a.D <= 128) return dispatch_q<T, 8>(a, block_q, block_k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (BH, Tq, D); k, v: (BH, Tk, D), contiguous, all of one dtype.
// qseg: (BH / H, Tq) and kseg: (BH / H, Tk) int32, or both null.
// out: (BH, Tq, D) in the operands' dtype; lse: (BH, Tq) float32.
// block_q, block_k: the tile, each 16, 32 or 64.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mxtt_flash_fwd(const void* q, const void* k, const void* v,
                              const int* qseg, const int* kseg, void* out,
                              float* lse, int BH, int H, int Tq, int Tk,
                              int D, float scale, int causal, int dtype,
                              int block_q, int block_k, void* stream) {
  if (BH < 1 || H < 1 || Tq < 1 || Tk < 0 || D < 1 || BH % H != 0 ||
      BH > 65535 || (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, qseg, kseg, out, lse, BH, H, Tq, Tk, D, scale,
               causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxtt::kFloat32) return dispatch<float>(a, block_q, block_k, s);
  if (dtype == mxtt::kBFloat16)
    return dispatch<__nv_bfloat16>(a, block_q, block_k, s);
  return cudaErrorInvalidValue;
}
