// Pieces shared by the tensor-core flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_bwd_dq.cu): the layout and staging of the two-stage
// ring of operand tiles in dynamic shared memory, ex2, and the alignment
// test that picks the staging path.
//
// A ring stage holds block_k rows of K and of V (or, in dK/dV, block_q rows
// of Q and of G), each padded by 16 bytes (fp32: D + 4, 2-byte types:
// D + 8 elements), then the tile's block_k ids. The padding makes the
// fragment reads of the kernels conflict-free: a thread that reads
// row[key = g][d = t] (the B operand of Q K^T) lands on bank 4g + t or its
// permutation (row stride 20, 36, 68 or 132 words), one that reads
// row[key = 2t (+1)][d = g] (the B operand of P V and dS K) on bank
// 8t + g; the 2-byte rows (12, 20, 36, 68 words) land on distinct banks
// the same way, two lanes sharing a word.
//
// Staged types: a tile lies in shared memory as staged_t<T>. fp32, bf16
// and fp16 tiles are staged raw; fp8 tiles are widened to fp16 on the way
// in (exact: every fp8 value is an fp16 value), so that every 1- and
// 2-byte dtype runs the same 2-byte tile code and the same one-product
// TF32 mma's (fp16, like bf16, is exact in TF32: 11 significant bits, and
// its subnormals are TF32 normals).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace mxtt {

// The type a tile of T lies in shared memory as.
template <typename T>
struct staged {
  using type = T;
};
template <>
struct staged<fp8e4m3> {
  using type = __half;
};
template <>
struct staged<fp8e5m2> {
  using type = __half;
};
template <typename T>
using staged_t = typename staged<T>::type;

// Elements of T that one staging chunk moves: 16 bytes of the staged type
// (8 fp8 values widen into 16 bytes of fp16).
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return 16 / static_cast<int>(sizeof(staged_t<T>));
}

// fp8 -> fp16, two at a time (the staging of widened tiles)
__device__ __forceinline__ unsigned widen2(unsigned short x, fp8e4m3*) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3);
  return static_cast<unsigned>(h.x) | (static_cast<unsigned>(h.y) << 16);
}
__device__ __forceinline__ unsigned widen2(unsigned short x, fp8e5m2*) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(x, __NV_E5M2);
  return static_cast<unsigned>(h.x) | (static_cast<unsigned>(h.y) << 16);
}
// one element of T as the staged type
template <typename T>
__device__ __forceinline__ staged_t<T> widen(T x) {
  if constexpr (std::is_same<staged_t<T>, T>::value) {
    return x;
  } else {
    return to_f16(x);
  }
}

// Row stride of a staged K/V tile in elements: the head-dim class kD plus
// 16 bytes.
template <typename T, int kD>
__host__ __device__ constexpr int row_stride() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

// Bytes of one ring stage: the K and V tiles and the tile's key ids.
template <typename T, int kD, int kBlockK>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * sizeof(T) * kBlockK * row_stride<T, kD>() +
         sizeof(int) * kBlockK;
}

// Issue the copies of keys [kb, kb + kBlockK) into one ring stage (S =
// staged_t<T>): when ``vec`` (rows of whole chunks from operands aligned
// to a chunk, chunk_elems<T>() elements), 16-byte cp.async chunks for a
// raw tile, or 8-byte loads widened to 16 bytes of fp16 for an fp8 tile
// (cp.async cannot convert); one element at a time otherwise; zero past
// Tk and past D. bf16 and fp16 tiles are converted to fp32 on the
// fragment load.
template <typename T, int kD, int kBlockK, int kThreads>
__device__ __forceinline__ void stage_kv(staged_t<T>* k_s, staged_t<T>* v_s,
                                         int* ks_s, const T* kbase,
                                         const T* vbase, const int* kseg,
                                         int kb, int Tk, int D, bool vec) {
  using S = staged_t<T>;
  constexpr bool kRaw = std::is_same<S, T>::value;
  constexpr int kStride = row_stride<S, kD>();
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kE = chunk_elems<T>();
    constexpr int kRowChunks = kD / kE;
    for (int c = tid; c < kBlockK * kRowChunks; c += kThreads) {
      const int j = c / kRowChunks;
      const int d = (c % kRowChunks) * kE;
      const int key = kb + j;
      const bool in = key < Tk && d < D;
      const size_t g = in ? (size_t)key * D + d : 0;
      if constexpr (kRaw) {
        cp_async16(k_s + j * kStride + d, kbase + g, in);
        cp_async16(v_s + j * kStride + d, vbase + g, in);
      } else {
        // 8 fp8 values -> 8 fp16 values: one 8-byte load, one 16-byte store
        auto put = [&](S* dst, const T* src) {
          uint2 raw = make_uint2(0u, 0u);
          if (in) raw = *reinterpret_cast<const uint2*>(src + g);
          uint4 w;
          w.x = widen2(static_cast<unsigned short>(raw.x), (T*)nullptr);
          w.y = widen2(static_cast<unsigned short>(raw.x >> 16), (T*)nullptr);
          w.z = widen2(static_cast<unsigned short>(raw.y), (T*)nullptr);
          w.w = widen2(static_cast<unsigned short>(raw.y >> 16), (T*)nullptr);
          *reinterpret_cast<uint4*>(dst + j * kStride + d) = w;
        };
        put(k_s, kbase);
        put(v_s, vbase);
      }
    }
  } else {
    const S zero = widen(from_f32<T>(0.f));
    for (int idx = tid; idx < kBlockK * kD; idx += kThreads) {
      const int j = idx / kD;
      const int d = idx % kD;
      const int key = kb + j;
      const bool in = key < Tk && d < D;
      const size_t g = (size_t)key * D + d;
      k_s[j * kStride + d] = in ? widen(kbase[g]) : zero;
      v_s[j * kStride + d] = in ? widen(vbase[g]) : zero;
    }
  }
  if (kseg != nullptr) {
    for (int j = tid; j < kBlockK; j += kThreads) {
      const int key = kb + j;
      cp_async4(ks_s + j, kseg + (key < Tk ? key : 0), key < Tk);
    }
  }
}

// 2^x (ex2.approx: ~2 ulp; -inf -> +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether operands a and b of T, rows of D elements, take the chunked
// staging path of stage_kv: whole chunks a row, both aligned to a chunk.
template <typename T>
inline bool vec_staging(int D, const void* a, const void* b) {
  constexpr size_t kBytes = sizeof(T) * chunk_elems<T>();
  return D % chunk_elems<T>() == 0 &&
         reinterpret_cast<uintptr_t>(a) % kBytes == 0 &&
         reinterpret_cast<uintptr_t>(b) % kBytes == 0;
}

}  // namespace mxtt
