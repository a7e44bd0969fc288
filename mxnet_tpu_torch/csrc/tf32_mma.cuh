// Tensor-core and copy primitives of the port's Hopper kernels: TF32
// mma.sync with the hi/lo split that keeps fp32 at fp32 accuracy
// ("3xTF32", what CUTLASS calls OpMultiplyAddFastF32), and cp.async.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k8"), for lane = 4 * g + t
// (g = lane / 4 the group, t = lane % 4 the thread in the group):
//   A (16 x 8, row-major):  a0 = A[g][t]    a1 = A[g + 8][t]
//                           a2 = A[g][t+4]  a3 = A[g + 8][t + 4]
//   B (8 x 8, column):      b0 = B[t][g]    b1 = B[t + 4][g]
//   C, D (16 x 8, fp32):    c0 = C[g][2t]   c1 = C[g][2t + 1]
//                           c2 = C[g+8][2t] c3 = C[g + 8][2t + 1]
#pragma once

#include <cuda_runtime.h>

namespace mxtt {

// D += A * B on the tensor cores, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// what cvt.rna.tf32.f32 gives for finite x, in two integer operations
// (half the dropped range added to the magnitude's bits carries into the
// kept bits exactly when the dropped part is at least half). sm_90 has no
// single instruction for the cvt: ptxas expands it into a compare-and-
// select sequence with a NaN check, which cost ~12 % of the kernel.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A value as the TF32 operands of kSplit products. kSplit == 3: hi =
// tf32(x), lo = tf32(x - hi), so hi + lo carries ~22 of x's 24 bits and
// a product is summed as lo*hi' + hi*lo' + hi*hi' (lo*lo' is below fp32's
// rounding). kSplit == 1 is only for values exact in TF32 (bf16: 7
// mantissa bits), whose bits are the operand and whose lo is 0.
template <int kSplit>
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  static_assert(kSplit == 1 || kSplit == 3, "1 or 3 TF32 products");
  if constexpr (kSplit == 3) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// 16-byte global -> shared copy, asynchronous; zero-fills when !pred
// (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// 4-byte global -> shared copy, asynchronous; zero-fills when !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace mxtt
