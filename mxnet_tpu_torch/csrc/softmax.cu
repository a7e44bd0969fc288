// Fused last-axis softmax, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _softmax_kernel
// (mxnet_tpu/ops/pallas_kernels.py:971-975), launched there by
// _fused_softmax_impl (:998-1015).
//
// Row-wise over the last axis, in fp32: m = max_c x_c, s = sum_c
// exp(x_c - m), out_c = exp(x_c - m) / s, cast back to x's dtype (float32
// or bfloat16). The reference drops to jax.nn.softmax when d % 128 != 0;
// that is the same function, so this kernel takes every width.
//
// What bounds it on this card: device memory. It does ~4 operations per
// element (one of them an exp) against 2 * sizeof(x) bytes moved (read x,
// write out). What the design does about it: one warp per row, kRowsPerBlock
// rows per block, consecutive lanes on consecutive elements so every pass is
// a coalesced read; the max and sum passes reduce in registers and across
// the warp with shuffles, and the second and third reads of a row (a
// 768-wide GPT-2 row is 3 KB) hit L1/L2, so x is read from device memory
// once and out written once. Any width and any row count work: lanes stride
// over the row, and a warp past the last row exits. A row as wide as GPT-2's
// vocabulary (50257) is one warp's loop of ~1571 elements a lane.
//
// The tile is a call parameter (the tuner picks it, ROADMAP B's rule):
// block_rows = kRowsPerBlock rows a block from {1, 2, 4, 8, 16, 32}, as the
// LayerNorm kernel; 4 is the default.
#include <math.h>

#include "common.cuh"

namespace {

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

}  // namespace

// x, out: (rows, d) contiguous, float32 or bfloat16 (dtype code);
// block_rows: rows a block, 1, 2, 4, 8, 16 or 32.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mxtt_softmax_fwd(const void* x, void* out, long long rows,
                                int d, int dtype, int block_rows,
                                void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxtt::kFloat32)
    return dispatch<float>(x, out, rows, d, block_rows, s);
  if (dtype == mxtt::kBFloat16)
    return dispatch<__nv_bfloat16>(x, out, rows, d, block_rows, s);
  return cudaErrorInvalidValue;
}
