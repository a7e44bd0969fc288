// Fused last-axis softmax, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _softmax_kernel
// (mxnet_tpu/ops/pallas_kernels.py:971-975), launched there by
// _fused_softmax_impl (:998-1015).
//
// Row-wise over the last axis, in fp32: m = max_c x_c, s = sum_c
// exp(x_c - m), out_c = exp(x_c - m) / s, cast back to x's dtype (float32,
// bfloat16 or float16). The reference drops to jax.nn.softmax when
// d % 128 != 0; that is the same function, so this kernel takes every
// width.
//
// What bounds it on this card: device memory. It does ~4 operations per
// element (one of them an exp) against 2 * sizeof(x) bytes moved (read x,
// write out). Two paths, chosen by the C entry point from the width alone:
//
// Narrow rows (d < kWideMinD = 4096): one warp per row, kRowsPerBlock rows
// per block, consecutive lanes on consecutive elements so every pass is a
// coalesced read; the max and sum passes reduce in registers and across
// the warp with shuffles, and the second and third reads of a row (a
// 768-wide GPT-2 row is 3 KB) hit L1/L2, so x is read from device memory
// once and out written once. A warp past the last row exits. The tile is a
// call parameter (the tuner picks it, ROADMAP B's rule): block_rows =
// kRowsPerBlock rows a block from {1, 2, 4, 8, 16, 32}, as the LayerNorm
// kernel; 4 is the default.
//
// Wide rows (d >= kWideMinD): a thread-block cluster of kCluster = 8
// blocks (the portable limit) owns one row, each block a contiguous slice
// of ceil(d / 8) elements, so 64 rows at GPT-2's vocabulary width (50257)
// run as 512 blocks of 256 threads instead of 64 warps. Why 4096: one warp
// walks a row in d / 32 sequential steps a lane, three times; at 4096 that
// is 128 steps a pass, a 16 KB fp32 row, and with the 64 warps an SM holds
// the rows in flight (1 MB) no longer fit its 256 KB of L1, so the second
// and third passes go to L2. Below it the narrow path reaches 68 % of its
// bound at (4096, 768) and is kept. The wide path ignores block_rows.
// - Each block loads its slice once from device memory into shared memory
//   as fp32: 16-byte vector loads over the slice's 16-byte-aligned body,
//   scalar loads for the head and tail (a row of odd width starts off a
//   16-byte boundary every other row, and a slice boundary falls
//   mid-vector). Shared memory is indexed from the aligned-down start, so
//   body vectors land on aligned float4 slots.
// - It reduces the slice to a partial (m_r, s_r): the block maximum, then
//   s_r = sum exp(x - m_r) over the staged slice (a thread adds ~25 terms
//   at vocabulary width, so no compensation is needed).
// - cluster.sync(); each block reads all eight partials from its peers'
//   shared memory (distributed shared memory, map_shared_rank) and
//   combines them in the fixed order r = 0..7: m = max m_r, s = sum s_r
//   exp(m_r - m). Every block computes the same (m, s) bit for bit.
// - It writes exp(x - m) / s from its staged slice (vector stores where
//   out has x's alignment), then cluster.sync() again, so that no block
//   exits while a peer may still read its partial.
// x is read from device memory once and out written once. A slice wider
// than kMaxStaged floats (~58K, rows wider than ~464K elements) does not
// fit a block's 227 KB of shared memory: such a row is not staged, and the
// block reads its slice three times (max, sum, write), from L2 after the
// first.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using mxtt::from_f32;
using mxtt::to_f32;
using mxtt::warp_sum;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int kRowsPerBlock>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ out,
                   long long rows, int d) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float m = -INFINITY;
  for (int c = lane; c < d; c += 32) m = fmaxf(m, to_f32(xr[c]));
  m = warp_max(m);

  // compensated (Kahan) sum: a lane adds up to d / 32 terms (1571 at a
  // 50257-wide vocabulary row), and a plain running sum would lose ~1e-6
  // of the total to rounding
  float s = 0.f, comp = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float y = expf(to_f32(xr[c]) - m) - comp;
    const float t = s + y;
    comp = (t - s) - y;
    s = t;
  }
  s = warp_sum(s);

  for (int c = lane; c < d; c += 32)
    orow[c] = from_f32<T>(expf(to_f32(xr[c]) - m) / s);
}

template <typename T, int kRowsPerBlock>
cudaError_t launch(const void* x, void* out, long long rows, int d,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  softmax_kernel<T, kRowsPerBlock>
      <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, long long rows, int d,
                     int block_rows, cudaStream_t s) {
  switch (block_rows) {
    case 1: return launch<T, 1>(x, out, rows, d, s);
    case 2: return launch<T, 2>(x, out, rows, d, s);
    case 4: return launch<T, 4>(x, out, rows, d, s);
    case 8: return launch<T, 8>(x, out, rows, d, s);
    case 16: return launch<T, 16>(x, out, rows, d, s);
    case 32: return launch<T, 32>(x, out, rows, d, s);
  }
  return cudaErrorInvalidValue;
}

// -- wide rows: one thread-block cluster a row ------------------------------
constexpr int kWideMinD = 4096;   // the width from which the wide path runs
constexpr int kCluster = 8;       // blocks a row: the portable cluster limit
constexpr int kWideThreads = 256;
// dynamic shared memory a staged slice may take: a block's 227 KB less a
// margin for the kernel's static shared memory
constexpr int kMaxStageBytes = 232448 - 1024;

bool legal_block_rows(int br) {
  return br == 1 || br == 2 || br == 4 || br == 8 || br == 16 || br == 32;
}

// 16 bytes of T (4 fp32, 8 bf16 or 8 fp16 values) as floats, and back
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(__half* p, const float* f) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The max (kMax) or sum of v over the block, in a fixed order, in every
// thread. ``red`` holds one word a warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  constexpr int kWarps = kWideThreads / 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is written again by the next reduction
  return r;
}

// Block ``rank`` of the cluster that owns row blockIdx.x / kCluster takes
// elements [rank * slice, rank * slice + slice) of it. kStaged: the slice
// is kept in shared memory as fp32 between the passes.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kWideThreads)
    softmax_wide_kernel(const T* __restrict__ x, T* __restrict__ out, int d,
                        int slice, int vec_out) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) float stage[];
  __shared__ float red[kWideThreads / 32];
  __shared__ float2 part;  // this block's (m_r, s_r), read by its peers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int lo = min(rank * slice, d);
  const int hi = min(lo + slice, d);
  // the slice's elements before its first 16-byte-aligned one; shared
  // memory is indexed from the aligned-down start ``base``, so the body's
  // vectors land on aligned float4 slots
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xr + lo) / sizeof(T)) % kVec);
  const int base = lo - mis;
  const int a0 = min(lo + (kVec - mis) % kVec, hi);  // body [a0, a1)
  const int a1 = a0 + (hi - a0) / kVec * kVec;

  // -- pass 1: load the slice once (stage it) and take its maximum --------
  float m = -INFINITY;
  auto scalar_in = [&](int c) {
    const float v = to_f32(xr[c]);
    if constexpr (kStaged) stage[c - base] = v;
    m = fmaxf(m, v);
  };
  if (tid < a0 - lo) scalar_in(lo + tid);  // head
  if (tid < hi - a1) scalar_in(a1 + tid);  // tail
#pragma unroll 4
  for (int c = a0 + tid * kVec; c < a1; c += kWideThreads * kVec) {
    float f[kVec];
    load16(xr + c, f);
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      if constexpr (kStaged)
        *reinterpret_cast<float4*>(stage + c - base + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      m = fmaxf(m, fmaxf(fmaxf(f[e], f[e + 1]), fmaxf(f[e + 2], f[e + 3])));
    }
  }
  m = block_reduce<true>(m, red);  // its barrier also orders the stage

  // -- pass 2: the slice's sum at its own maximum ---------------------------
  float s = 0.f;
  for (int c = lo + tid; c < hi; c += kWideThreads)
    s += expf((kStaged ? stage[c - base] : to_f32(xr[c])) - m);
  s = block_reduce<false>(s, red);
  if (tid == 0) part = make_float2(m, s);
  cluster.sync();

  // -- combine the cluster's partials in a fixed order ----------------------
  float2 pr[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) pr[r] = *cluster.map_shared_rank(&part, r);
  float mx = pr[0].x;
#pragma unroll
  for (int r = 1; r < kCluster; ++r) mx = fmaxf(mx, pr[r].x);
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) sum += pr[r].y * expf(pr[r].x - mx);

  // -- pass 3: write exp(x - m) / s -----------------------------------------
  auto scalar_out = [&](int c) {
    const float v = kStaged ? stage[c - base] : to_f32(xr[c]);
    orow[c] = from_f32<T>(expf(v - mx) / sum);
  };
  if (tid < a0 - lo) scalar_out(lo + tid);
  if (tid < hi - a1) scalar_out(a1 + tid);
#pragma unroll 4
  for (int c = a0 + tid * kVec; c < a1; c += kWideThreads * kVec) {
    float f[kVec];
    if constexpr (kStaged) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(stage + c - base + e);
        f[e] = v.x;
        f[e + 1] = v.y;
        f[e + 2] = v.z;
        f[e + 3] = v.w;
      }
    } else {
      load16(xr + c, f);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = expf(f[e] - mx) / sum;
    if (vec_out) {
      store16(orow + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) orow[c + e] = from_f32<T>(f[e]);
    }
  }
  // no block leaves while a peer may still read its partial
  cluster.sync();
}

template <typename T, bool kStaged>
cudaError_t launch_wide(const void* x, void* out, long long rows, int d,
                        int slice, cudaStream_t stream) {
  auto kernel = softmax_wide_kernel<T, kStaged>;
  const size_t smem =
      kStaged ? sizeof(float) * (slice + 16 / sizeof(T)) : 0;
  if (smem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
    if (attr != cudaSuccess) return attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * kCluster));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // vector stores where out lies at x's offset from a 16-byte boundary
  const int vec_out =
      (reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(out)) %
          16 == 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<T*>(out), d, slice,
      vec_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wide(const void* x, void* out, long long rows, int d,
                          cudaStream_t s) {
  if (rows * kCluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int slice = (d + kCluster - 1) / kCluster;
  if (sizeof(float) * (slice + 16 / sizeof(T)) <= (size_t)kMaxStageBytes)
    return launch_wide<T, true>(x, out, rows, d, slice, s);
  return launch_wide<T, false>(x, out, rows, d, slice, s);
}

}  // namespace

// x, out: (rows, d) contiguous, float32, bfloat16 or float16 (dtype code);
// block_rows: rows a block of the narrow path, 1, 2, 4, 8, 16 or 32 (the
// wide path, d >= 4096, checks it and runs one cluster a row).
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mxtt_softmax_fwd(const void* x, void* out, long long rows,
                                int d, int dtype, int block_rows,
                                void* stream) {
  if (rows < 1 || d < 1 || !legal_block_rows(block_rows))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = d >= kWideMinD;
  if (dtype == mxtt::kFloat32)
    return wide ? dispatch_wide<float>(x, out, rows, d, s)
                : dispatch<float>(x, out, rows, d, block_rows, s);
  if (dtype == mxtt::kBFloat16)
    return wide ? dispatch_wide<__nv_bfloat16>(x, out, rows, d, s)
                : dispatch<__nv_bfloat16>(x, out, rows, d, block_rows, s);
  if (dtype == mxtt::kFloat16)
    return wide ? dispatch_wide<__half>(x, out, rows, d, s)
                : dispatch<__half>(x, out, rows, d, block_rows, s);
  return cudaErrorInvalidValue;
}
