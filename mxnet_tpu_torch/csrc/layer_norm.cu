// Fused LayerNorm forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ln_kernel
// (mxnet_tpu/ops/pallas_kernels.py:866-873), launched there by _fused_ln
// (:924-951).
//
// Row-wise over the last axis: fp32 mean and population variance (two
// passes, as the reference), out = (x - mean) * rsqrt(var + eps) * gamma
// + beta, cast back to x's dtype (float32, bfloat16 or float16; fp16 with
// inf on overflow, as XLA's cast). gamma/beta may be float32 while x is
// bfloat16 or float16 (amp.convert_hybrid_block keeps the norm parameters
// fp32), or of x's dtype.
//
// What bounds it on this card: device memory. It does ~8 FLOPs per element
// against 2 * sizeof(x) bytes moved (read x, write out), far below the
// card's ~20 FLOP/byte fp32 balance point. What the design does about it:
// one warp per row, kRowsPerBlock rows per block, consecutive lanes on
// consecutive elements so every pass is a coalesced read; the second and
// third passes over a row (a 768-wide GPT-2 row is 3 KB) hit L1/L2 instead
// of device memory, so x is read from HBM once and out written once. Any
// width and any row count work: lanes stride over the row, and a warp past
// the last row exits.
//
// The tile is a call parameter (the tuner picks it, ROADMAP B's rule):
// block_rows = kRowsPerBlock rows a block, one warp a row, from
// {1, 2, 4, 8, 16, 32}; 4 is the default. (In the Pallas kernel block_rows
// counts rows a grid step, up to 1024; here a block holds at most 32
// warps.)
#include <math.h>

#include "common.cuh"

namespace {

using mxtt::from_f32;
using mxtt::to_f32;
using mxtt::warp_sum;

template <typename TX, typename TP, int kRowsPerBlock>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layer_norm_kernel(const TX* __restrict__ x, const TP* __restrict__ gamma,
                      const TP* __restrict__ beta, TX* __restrict__ out,
                      long long rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const TX* xr = x + row * d;
  TX* orow = out + row * d;

  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / d;

  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = to_f32(xr[c]) - mean;
    ss += xc * xc;
  }
  const float var = warp_sum(ss) / d;
  const float inv = 1.0f / sqrtf(var + eps);

  for (int c = lane; c < d; c += 32) {
    const float xc = to_f32(xr[c]) - mean;
    orow[c] = from_f32<TX>(xc * inv * to_f32(gamma[c]) + to_f32(beta[c]));
  }
}

template <typename TX, typename TP, int kRowsPerBlock>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* out, long long rows, int d, float eps,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  layer_norm_kernel<TX, TP, kRowsPerBlock>
      <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TP*>(gamma),
          static_cast<const TP*>(beta), static_cast<TX*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TP>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta,
                     void* out, long long rows, int d, float eps,
                     int block_rows, cudaStream_t s) {
  switch (block_rows) {
    case 1: return launch<TX, TP, 1>(x, gamma, beta, out, rows, d, eps, s);
    case 2: return launch<TX, TP, 2>(x, gamma, beta, out, rows, d, eps, s);
    case 4: return launch<TX, TP, 4>(x, gamma, beta, out, rows, d, eps, s);
    case 8: return launch<TX, TP, 8>(x, gamma, beta, out, rows, d, eps, s);
    case 16: return launch<TX, TP, 16>(x, gamma, beta, out, rows, d, eps, s);
    case 32: return launch<TX, TP, 32>(x, gamma, beta, out, rows, d, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (rows, d) contiguous in x_dtype; gamma, beta: (d,) in p_dtype
// (x float32 or bfloat16 with p float32 or bfloat16; x float16 with p
// float32 or float16);
// block_rows: rows a block, 1, 2, 4, 8, 16 or 32.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mxtt_layer_norm_fwd(const void* x, const void* gamma,
                                   const void* beta, void* out,
                                   long long rows, int d, float eps,
                                   int x_dtype, int p_dtype, int block_rows,
                                   void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int br = block_rows;
  if (x_dtype == mxtt::kFloat32 && p_dtype == mxtt::kFloat32)
    return dispatch<float, float>(x, gamma, beta, out, rows, d, eps, br, s);
  if (x_dtype == mxtt::kBFloat16 && p_dtype == mxtt::kFloat32)
    return dispatch<bf16, float>(x, gamma, beta, out, rows, d, eps, br, s);
  if (x_dtype == mxtt::kBFloat16 && p_dtype == mxtt::kBFloat16)
    return dispatch<bf16, bf16>(x, gamma, beta, out, rows, d, eps, br, s);
  if (x_dtype == mxtt::kFloat32 && p_dtype == mxtt::kBFloat16)
    return dispatch<float, bf16>(x, gamma, beta, out, rows, d, eps, br, s);
  if (x_dtype == mxtt::kFloat16 && p_dtype == mxtt::kFloat32)
    return dispatch<__half, float>(x, gamma, beta, out, rows, d, eps, br, s);
  if (x_dtype == mxtt::kFloat16 && p_dtype == mxtt::kFloat16)
    return dispatch<__half, __half>(x, gamma, beta, out, rows, d, eps, br, s);
  return cudaErrorInvalidValue;
}
