// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel source in this directory is compiled on its own by nvcc
// into a shared library with a plain C interface (loaded from Python with
// ctypes, see mxnet_tpu_torch/ops/_build.py). Element types cross that
// interface as an int code: 0 = float32, 1 = bfloat16, 2 = float16,
// 3 = float8_e4m3fn, 4 = float8_e5m2. A kernel with many instances is
// kept in a header and built as several libraries, one small source each
// that names its element types (mxtt::Instances, a TypeList) before it
// includes the header, so that the libraries compile in parallel; a C entry
// point refuses the codes its library has no instance of.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace mxtt {

enum DType : int {
  kFloat32 = 0,
  kBFloat16 = 1,
  kFloat16 = 2,
  kFloat8E4M3 = 3,
  kFloat8E5M2 = 4
};

using fp8e4m3 = __nv_fp8_e4m3;
using fp8e5m2 = __nv_fp8_e5m2;

template <typename... Ts>
struct TypeList {};

// the code of each element type
template <typename T>
constexpr int kCode = -1;
template <>
constexpr int kCode<float> = kFloat32;
template <>
constexpr int kCode<__nv_bfloat16> = kBFloat16;
template <>
constexpr int kCode<__half> = kFloat16;
template <>
constexpr int kCode<fp8e4m3> = kFloat8E4M3;
template <>
constexpr int kCode<fp8e5m2> = kFloat8E5M2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
// fp8 widens exactly to fp16 (e5m2 is fp16's top byte; e4m3's range and
// precision lie inside fp16's), and fp16 exactly to fp32; NaN stays NaN
__device__ __forceinline__ __half to_f16(fp8e4m3 x) {
  return __half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3));
}
__device__ __forceinline__ __half to_f16(fp8e5m2 x) {
  return __half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2));
}
__device__ __forceinline__ float to_f32(fp8e4m3 x) {
  return __half2float(to_f16(x));
}
__device__ __forceinline__ float to_f32(fp8e5m2 x) {
  return __half2float(to_f16(x));
}

// fp32 -> T, rounded to nearest even, with XLA's overflow: fp16 and e5m2
// give inf, e4m3fn (which has no inf) gives NaN past 464 (__NV_NOSAT; a
// saturating store would turn an overflow the loss scaler must see into a
// finite value)
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ fp8e4m3 from_f32<fp8e4m3>(float x) {
  fp8e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
  return r;
}
template <>
__device__ __forceinline__ fp8e5m2 from_f32<fp8e5m2>(float x) {
  fp8e5m2 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E5M2);
  return r;
}

// x rounded to T and back, for x in [0, 1] (the attention probabilities):
// no overflow is possible, so fp8 takes the hardware's one-instruction
// conversion (cvt.rn.satfinite), which rounds such values as from_f32 does
template <typename T>
__device__ __forceinline__ float round_unit(float x) {
  return to_f32(from_f32<T>(x));
}
template <>
__device__ __forceinline__ float round_unit<fp8e4m3>(float x) {
  fp8e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return to_f32(r);
}
template <>
__device__ __forceinline__ float round_unit<fp8e5m2>(float x) {
  fp8e5m2 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E5M2);
  return to_f32(r);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mxtt
