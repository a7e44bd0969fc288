// Flash-attention forward on Hopper's tensor cores (sm_90a).
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
//   lse_i     = m_i + log(max(l_i, 1e-30))          (natural log)
// with an online softmax over key tiles: fp32 running max m (from the
// reference's finite -1e30), sum l and accumulator per row. A row that sees
// no key keeps m = -1e30, l = 0 and emits zeros.
//
// What bounds it on this card: 4*D operations per visible (query, key)
// pair against 4 bytes a value moved, so operations, not device memory.
// Both products, S = Q K^T and P V, run on the tensor cores as
// mma.sync.m16n8k8 TF32 (tf32_mma.cuh). One TF32 product keeps ~11 bits,
// which would break the 1e-4 the kernel is held to, so fp32 operands are
// split hi + lo and each product is summed as lo*hi' + hi*lo' + hi*hi'
// (3xTF32): fp32 accuracy at 3 tensor-core products, whose 495 TFLOP/s
// rate sets the least time (chip_smoke.py's bound). bf16 values are exact
// in TF32 (lo = 0), so bf16 takes 1 product (kSplit, a template
// parameter), through the same code. Measured on an H100, the kernel
// reaches ~12 % of that bound at GPT-2 prefill shapes, held back by
// instruction issue: a warp issues ~1100 instructions a 32-key tile, 192
// of them mma's, most of the rest the hi/lo splits of the K and V
// fragments every warp makes for its own 16 rows (PERF.md).
//
// Design:
// - Work split: a warp owns 16 query rows (the mma's M); a block has
//   block_q / 16 warps and walks the keys in tiles of block_k. A warp keeps
//   its rows' O accumulator (16 x D) and both rows' m, l in registers.
//   Q's split fragments are loaded once into registers for D <= 64; at
//   D = 128 they are re-read from global memory (L1) for every key tile
//   rather than held in 128 registers (fp32 D = 128 still spills a few
//   bytes; D = 64 does not).
// - K/V staging: cp.async copies 16-byte chunks of each K and V tile
//   (zero-filled past Tk and past D) into a two-stage ring in dynamic
//   shared memory, so the next tile loads while this one multiplies. Rows
//   are padded by 16 bytes (fp32: D + 4, bf16: D + 8 elements), which
//   makes both fragment reads conflict-free: for S a thread reads
//   K[key = g][d = t] (row stride 20, 36, 68 or 132 words: g*stride mod 32
//   = 4g or its permutation, + t -> 32 banks); for P V it reads
//   V[key = 2t (+1)][d = g] (2t*stride = 8t mod 32, + g -> 32 banks); the
//   bf16 rows (12, 20, 36, 68 words) land on distinct banks the same way,
//   two lanes sharing a word. bf16 tiles are staged raw and converted on
//   the fragment load: half the bytes and shared memory, and cp.async
//   cannot convert. Rows whose bytes are not a multiple of 16 (fp32 with
//   D % 4 != 0, bf16 with D % 8 != 0) or operands not 16-byte aligned are
//   staged by plain loads into the same ring.
// - Online softmax on the accumulator fragments: a thread holds rows g and
//   g + 8; the row max is reduced over the quad (4 threads of a group) by
//   two shuffles, the row sum is kept per thread and reduced once at the
//   end. Scores are kept in log2 units (scale * log2(e) folded into the
//   one multiply), so p = 2^(s - m) is one ex2.approx; the LSE goes back to
//   natural log at the end. Hidden scores (ragged edge, causal, segment
//   ids staged with the tile) are set to -inf by a branch-free test, so
//   2^x zeroes them, and the running max, which starts at the finite
//   -1e30, never reaches -inf: a fully hidden row gets 2^(-inf + 1e30) = 0
//   and alpha = 2^0 = 1.
// - P V without a shared-memory round trip: the S accumulator gives a
//   thread keys 2t and 2t+1 of an 8-key n-tile, the TF32 A operand wants
//   k-slots t and t+4. The sum over keys does not care about order, so the
//   S fragment is reused as the A operand as it lies:
//       a0 = p(row g,     key 2t)     -> k-slot t
//       a1 = p(row g + 8, key 2t)     -> k-slot t
//       a2 = p(row g,     key 2t + 1) -> k-slot t + 4
//       a3 = p(row g + 8, key 2t + 1) -> k-slot t + 4
//   and V's rows are read in the same permuted order:
//       b0 = V[key 2t][d = g]   (k-slot t),
//       b1 = V[key 2t + 1][d = g]   (k-slot t + 4).
//   p is cast to V's dtype before the product (the reference's
//   p.astype(v.dtype); exact in TF32 for bf16), l sums the uncast p.
// - Causal blocks stop at the last key any of their rows can see, and a
//   warp skips the tiles past its own rows' last visible key.
//
// Tiles are call parameters (the tuner picks them, ROADMAP B's rule):
// block_q query rows a block and block_k keys a tile, each from
// {16, 32, 64}; (32, 32) is the default.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using mxtt::cp_async16;
using mxtt::cp_async4;
using mxtt::from_f32;
using mxtt::split_tf32;
using mxtt::to_f32;

// Row stride of a staged K/V tile in elements: the head-dim class kD plus
// 16 bytes (see the bank analysis above).
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

// Issue the copies of keys [kb, kb + kBlockK) into one ring stage.
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

template <typename T>
__device__ __forceinline__ float q_at(const T* qbase, int r, int d, int Tq,
                                      int D) {
  return (r < Tq && d < D) ? to_f32(qbase[(size_t)r * D + d]) : 0.f;
}

// The A fragment of Q for k-step ks (dims 8ks..8ks+7), split.
template <typename T, int kSplit>
__device__ __forceinline__ void load_q(const T* qbase, int r0, int ks, int t,
                                       int Tq, int D, unsigned (&ah)[4],
                                       unsigned (&al)[4]) {
  const int d = ks * 8 + t;
  split_tf32<kSplit>(q_at(qbase, r0, d, Tq, D), ah[0], al[0]);
  split_tf32<kSplit>(q_at(qbase, r0 + 8, d, Tq, D), ah[1], al[1]);
  split_tf32<kSplit>(q_at(qbase, r0, d + 4, Tq, D), ah[2], al[2]);
  split_tf32<kSplit>(q_at(qbase, r0 + 8, d + 4, Tq, D), ah[3], al[3]);
}

// 2^x (ex2.approx: ~2 ulp; -inf -> +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p as the P V product sees it: cast to V's dtype (a no-op in fp32)
template <typename T>
__device__ __forceinline__ float as_v(float p) {
  return to_f32(from_f32<T>(p));
}

// kD: the head-dim class (16, 32, 64, 128) the fragments cover; kSplit:
// TF32 products per product (3 for fp32, 1 for bf16).
template <typename T, int kD, int kBlockQ, int kBlockK, int kSplit>
__global__ void __launch_bounds__(kBlockQ * 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, int D,
                     float scale, int causal, int vec) {
  static_assert(kBlockQ % 16 == 0 && kBlockK % 8 == 0 && kD % 8 == 0,
                "tiles of the m16n8k8 steps");
  constexpr int kThreads = kBlockQ * 2;   // kBlockQ / 16 warps
  constexpr int kStride = row_stride<T, kD>();
  constexpr int kDSteps = kD / 8;         // k-steps of S, n-tiles of O
  constexpr int kKeySteps = kBlockK / 8;  // n-tiles of S, k-steps of P V
  constexpr bool kQInRegs = kD <= 64;
  constexpr size_t kStage = stage_bytes<T, kD, kBlockK>();
  extern __shared__ __align__(16) unsigned char smem[];

  const float kNegInf = __int_as_float(0xff800000);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int r0 = w0 + g;          // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int offset = Tk - Tq;
  const bool use_seg = qseg != nullptr;

  // keys the block stages, and keys this warp's rows can see
  int kend = Tk;
  int wend = w0 < Tq ? Tk : 0;
  if (causal) {
    kend = min(Tk, max(min(q0 + kBlockQ, Tq) + offset, 0));
    if (w0 < Tq) wend = min(Tk, max(min(w0 + 16, Tq) + offset, 0));
  }
  const T* qbase = q + (size_t)bh * Tq * D;
  const T* kbase = k + (size_t)bh * Tk * D;
  const T* vbase = v + (size_t)bh * Tk * D;
  const int* kseg_b = use_seg ? kseg + (size_t)b * Tk : nullptr;
  // without ids every key carries id 0 (ks_s is zeroed once below), so
  // the mask below is the same branch-free test either way
  const int qs0 = (use_seg && r0 < Tq) ? qseg[(size_t)b * Tq + r0] : 0;
  const int qs1 = (use_seg && r1 < Tq) ? qseg[(size_t)b * Tq + r1] : 0;
  // the last key rows r0, r1 may see: the ragged edge and the causal limit
  const int lim0 = causal ? min(r0 + offset, Tk - 1) : Tk - 1;
  const int lim1 = causal ? min(r1 + offset, Tk - 1) : Tk - 1;
  // scores in log2 units, so p = 2^(s2 - m2) is one ex2 instruction
  const float scale2 = scale * 1.4426950408889634f;

  unsigned qh[kQInRegs ? kDSteps : 1][4];
  unsigned ql[kQInRegs ? kDSteps : 1][4];
  if constexpr (kQInRegs) {
    if (w0 < Tq) {
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks)
        load_q<T, kSplit>(qbase, r0, ks, t, Tq, D, qh[ks], ql[ks]);
    }
  }

  // O n-tile nd holds dims 8nd + 2t, 8nd + 2t + 1 of rows r0 (o[nd][0..1])
  // and r1 (o[nd][2..3])
  float o[kDSteps][4];
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;  // the running max (log2 units), from
                                   // the reference's finite "-inf"
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the row sums

  auto k_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * kStage);
  };
  auto v_tile = [&](int s) { return k_tile(s) + kBlockK * kStride; };
  auto ks_tile = [&](int s) {
    return reinterpret_cast<int*>(k_tile(s) + 2 * kBlockK * kStride);
  };

  if (!use_seg) {
    for (int j = tid; j < kBlockK; j += kThreads)
      ks_tile(0)[j] = ks_tile(1)[j] = 0;
  }
  if (kend > 0)
    stage_kv<T, kD, kBlockK, kThreads>(k_tile(0), v_tile(0), ks_tile(0),
                                       kbase, vbase, kseg_b, 0, Tk, D, vec);
  mxtt::cp_async_commit();
  int cur = 0;
  for (int kb = 0; kb < kend; kb += kBlockK, cur ^= 1) {
    // the next tile loads into the other stage while this one multiplies
    if (kb + kBlockK < kend)
      stage_kv<T, kD, kBlockK, kThreads>(
          k_tile(cur ^ 1), v_tile(cur ^ 1), ks_tile(cur ^ 1), kbase, vbase,
          kseg_b, kb + kBlockK, Tk, D, vec);
    mxtt::cp_async_commit();
    mxtt::cp_async_wait<1>();  // every group but the one just issued
    __syncthreads();

    if (kb < wend) {
      const T* k_s = k_tile(cur);
      const T* v_s = v_tile(cur);
      const int* ks_s = ks_tile(cur);

      // -- S = Q K^T: rows r0, r1 x keys kb + 8nt + 2t (+1) -------------
      // Each k-step loads and splits all its K fragments first, then issues
      // the products in passes over the n-tiles (the small ones first), so
      // consecutive mma's are independent: a warp issues in order, and a
      // chain of dependent mma's would wait out the tensor core's latency
      // at every step.
      float s[kKeySteps][4];
#pragma unroll
      for (int nt = 0; nt < kKeySteps; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        unsigned ah[4], al[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[ks][i];
            al[i] = ql[ks][i];
          }
        } else {
          load_q<T, kSplit>(qbase, r0, ks, t, Tq, D, ah, al);
        }
        // B = K^T: b0 = K[key 8nt + g][d 8ks + t], b1 at d + 4
        unsigned bh[kKeySteps][2], bl[kKeySteps][2];
#pragma unroll
        for (int nt = 0; nt < kKeySteps; ++nt) {
          const T* kr = k_s + (nt * 8 + g) * kStride + ks * 8 + t;
          split_tf32<kSplit>(to_f32(kr[0]), bh[nt][0], bl[nt][0]);
          split_tf32<kSplit>(to_f32(kr[4]), bh[nt][1], bl[nt][1]);
        }
        if constexpr (kSplit == 3) {
#pragma unroll
          for (int nt = 0; nt < kKeySteps; ++nt)
            mxtt::mma_tf32(s[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < kKeySteps; ++nt)
            mxtt::mma_tf32(s[nt], ah, bl[nt][0], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < kKeySteps; ++nt)
          mxtt::mma_tf32(s[nt], ah, bh[nt][0], bh[nt][1]);
      }

      // -- mask, online softmax on the fragments ------------------------
      // hidden scores -> -inf; branch-free (ids of keys 2t, 2t + 1 in one
      // 8-byte load)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < kKeySteps; ++nt) {
        const int j = kb + nt * 8 + 2 * t;
        const int2 kid = *reinterpret_cast<const int2*>(ks_s + nt * 8 + 2 * t);
        s[nt][0] = (j <= lim0 && kid.x == qs0) ? s[nt][0] * scale2 : kNegInf;
        s[nt][1] = (j < lim0 && kid.y == qs0) ? s[nt][1] * scale2 : kNegInf;
        s[nt][2] = (j <= lim1 && kid.x == qs1) ? s[nt][2] * scale2 : kNegInf;
        s[nt][3] = (j < lim1 && kid.y == qs1) ? s[nt][3] * scale2 : kNegInf;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = exp2_approx(m0 - mx0);
      const float alpha1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int nd = 0; nd < kDSteps; ++nd) {
        o[nd][0] *= alpha0;
        o[nd][1] *= alpha0;
        o[nd][2] *= alpha1;
        o[nd][3] *= alpha1;
      }
      // p in place of s: s[kk][0..3] = p(r0, key 2t), p(r0, key 2t + 1),
      // p(r1, key 2t), p(r1, key 2t + 1)
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[kk][e] = exp2_approx(s[kk][e] - (e < 2 ? m0 : m1));
        l0 += s[kk][0] + s[kk][1];
        l1 += s[kk][2] + s[kk][3];
      }

      // -- O += P V, P straight from the S fragments (see the header) ----
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        unsigned ph[4], pl[4];
        split_tf32<kSplit>(as_v<T>(s[kk][0]), ph[0], pl[0]);  // k-slot t
        split_tf32<kSplit>(as_v<T>(s[kk][2]), ph[1], pl[1]);  // k-slot t
        split_tf32<kSplit>(as_v<T>(s[kk][1]), ph[2], pl[2]);  // k-slot t+4
        split_tf32<kSplit>(as_v<T>(s[kk][3]), ph[3], pl[3]);  // k-slot t+4
        // b0 = V[key 2t][d 8nd + g] (k-slot t), b1 = V[key 2t + 1] (t + 4)
        const T* vr = v_s + (kk * 8 + 2 * t) * kStride + g;
        unsigned bh[kDSteps][2], bl[kDSteps][2];
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd) {
          split_tf32<kSplit>(to_f32(vr[nd * 8]), bh[nd][0], bl[nd][0]);
          split_tf32<kSplit>(to_f32(vr[kStride + nd * 8]), bh[nd][1],
                             bl[nd][1]);
        }
        // passes over the n-tiles, as for S
        if constexpr (kSplit == 3) {
#pragma unroll
          for (int nd = 0; nd < kDSteps; ++nd)
            mxtt::mma_tf32(o[nd], pl, bh[nd][0], bh[nd][1]);
#pragma unroll
          for (int nd = 0; nd < kDSteps; ++nd)
            mxtt::mma_tf32(o[nd], ph, bl[nd][0], bl[nd][1]);
        }
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
          mxtt::mma_tf32(o[nd], ph, bh[nd][0], bh[nd][1]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // -- epilogue: the quad's row sums, O / l, the LSE ----------------------
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  T* obase = out + (size_t)bh * Tq * D;
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd) {
    const int d = nd * 8 + 2 * t;
    if (r0 < Tq) {
      if (d < D) obase[(size_t)r0 * D + d] = from_f32<T>(o[nd][0] / den0);
      if (d + 1 < D)
        obase[(size_t)r0 * D + d + 1] = from_f32<T>(o[nd][1] / den0);
    }
    if (r1 < Tq) {
      if (d < D) obase[(size_t)r1 * D + d] = from_f32<T>(o[nd][2] / den1);
      if (d + 1 < D)
        obase[(size_t)r1 * D + d + 1] = from_f32<T>(o[nd][3] / den1);
    }
  }
  // lse = m + log(max(l, 1e-30)) in natural units; a row that saw no key
  // (l = 0, m = -1e30) gets -1e30 + log(1e-30), which is -1e30 in fp32
  constexpr float kLn2 = 0.6931471805599453f;
  if (t == 0) {
    if (r0 < Tq)
      lse[(size_t)bh * Tq + r0] = l0 > 0.f ? kLn2 * (m0 + log2f(l0)) : -1e30f;
    if (r1 < Tq)
      lse[(size_t)bh * Tq + r1] = l1 > 0.f ? kLn2 * (m1 + log2f(l1)) : -1e30f;
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int kD, int kBlockQ, int kBlockK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSplit = std::is_same<T, float>::value ? 3 : 1;
  auto kernel = flash_fwd_kernel<T, kD, kBlockQ, kBlockK, kSplit>;
  constexpr size_t kSmem = 2 * stage_bytes<T, kD, kBlockK>();
  if (kSmem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
  }
  // cp.async moves 16-byte chunks: whole rows of 16-byte multiples from
  // 16-byte aligned operands; anything else takes the plain staging path
  const int vec = (a.D * sizeof(T)) % 16 == 0 && aligned16(a.k) &&
                  aligned16(a.v);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.BH);
  kernel<<<grid, kBlockQ * 2, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qseg, a.kseg, static_cast<T*>(a.out),
      a.lse, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  return cudaGetLastError();
}

template <typename T, int kD, int kBlockQ>
cudaError_t dispatch_k(const Args& a, int block_k, cudaStream_t s) {
  switch (block_k) {
    case 16: return launch<T, kD, kBlockQ, 16>(a, s);
    case 32: return launch<T, kD, kBlockQ, 32>(a, s);
    case 64: return launch<T, kD, kBlockQ, 64>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int kD>
cudaError_t dispatch_q(const Args& a, int block_q, int block_k,
                       cudaStream_t s) {
  switch (block_q) {
    case 16: return dispatch_k<T, kD, 16>(a, block_k, s);
    case 32: return dispatch_k<T, kD, 32>(a, block_k, s);
    case 64: return dispatch_k<T, kD, 64>(a, block_k, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int block_q, int block_k,
                     cudaStream_t s) {
  if (a.D <= 16) return dispatch_q<T, 16>(a, block_q, block_k, s);
  if (a.D <= 32) return dispatch_q<T, 32>(a, block_q, block_k, s);
  if (a.D <= 64) return dispatch_q<T, 64>(a, block_q, block_k, s);
  if (a.D <= 128) return dispatch_q<T, 128>(a, block_q, block_k, s);
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
