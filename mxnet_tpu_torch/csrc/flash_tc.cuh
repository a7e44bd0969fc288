// Pieces shared by the tensor-core flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu): the layout and staging of the two-stage K/V ring in
// dynamic shared memory, ex2, and the 16-byte alignment test that picks
// the staging path.
//
// A ring stage holds block_k rows of K and of V, each padded by 16 bytes
// (fp32: D + 4, bf16: D + 8 elements), then the tile's block_k key ids.
// The padding makes the fragment reads of both kernels conflict-free: a
// thread that reads row[key = g][d = t] (the B operand of Q K^T) lands on
// bank 4g + t or its permutation (row stride 20, 36, 68 or 132 words), one
// that reads row[key = 2t (+1)][d = g] (the B operand of P V and dS K) on
// bank 8t + g; the bf16 rows (12, 20, 36, 68 words) land on distinct banks
// the same way, two lanes sharing a word.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace mxtt {

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

// Issue the copies of keys [kb, kb + kBlockK) into one ring stage: 16-byte
// cp.async chunks when ``vec`` (rows of 16-byte multiples from 16-byte
// aligned operands), plain loads otherwise; zero past Tk and past D. bf16
// tiles are staged raw (cp.async cannot convert) and converted on the
// fragment load.
template <typename T, int kD, int kBlockK, int kThreads>
__device__ __forceinline__ void stage_kv(T* k_s, T* v_s, int* ks_s,
                                         const T* kbase, const T* vbase,
                                         const int* kseg, int kb, int Tk,
                                         int D, bool vec) {
  constexpr int kStride = row_stride<T, kD>();
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kRowChunks = kD / kE;
    for (int c = tid; c < kBlockK * kRowChunks; c += kThreads) {
      const int j = c / kRowChunks;
      const int d = (c % kRowChunks) * kE;
      const int key = kb + j;
      const bool in = key < Tk && d < D;
      const size_t g = in ? (size_t)key * D + d : 0;
      cp_async16(k_s + j * kStride + d, kbase + g, in);
      cp_async16(v_s + j * kStride + d, vbase + g, in);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int idx = tid; idx < kBlockK * kD; idx += kThreads) {
      const int j = idx / kD;
      const int d = idx % kD;
      const int key = kb + j;
      const bool in = key < Tk && d < D;
      const size_t g = (size_t)key * D + d;
      k_s[j * kStride + d] = in ? kbase[g] : zero;
      v_s[j * kStride + d] = in ? vbase[g] : zero;
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

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mxtt
