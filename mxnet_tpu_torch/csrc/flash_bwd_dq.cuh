// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a).
//
// Built as three libraries: flash_bwd_dq.cu (float32, bfloat16),
// flash_bwd_dq_f16.cu (float16) and flash_bwd_dq_f8.cu (the two fp8
// formats) each name their element types (mxtt::Instances) and include
// this file.
//
// Replaces the Pallas TPU kernel _flash_bwd_dq_kernel
// (mxnet_tpu/ops/pallas_kernels.py:587-635), launched there by
// _flash_bwd_tpu (:638-740), in both its plain and segment-id forms. The
// dK/dV half of the backward is flash_bwd.cu.
//
// With the forward's fp32 log-sum-exp lse_i (-1e30 for a row that sees no
// key) and Delta_i = sum_d g_id o_id (fp32, computed by the caller as the
// reference does at :647-648), for each fused batch-head bh (batch
// b = bh / H), query i and key j:
//   s_ij    = (q_i . k_j) * scale                                     fp32
//   visible = j < Tk                    (the ragged edge: a zero-filled key
//                                        scores 0, which exp(0 - lse) would
//                                        not zero)
//           && (!causal || j <= i + (Tk - Tq))              (bottom-right)
//           && (!seg    || qseg[b, i] == kseg[b, j])
//   p_ij    = visible ? exp(s_ij - lse_i) : 0
//   dp_ij   = g_i . v_j
//   ds_ij   = p_ij (dp_ij - Delta_i) * scale
//   dQ_i    = sum_j ds_ij k_j
// p is forced to 0 under the combined mask, never computed and then
// masked: with lse = -1e30, exp(s - lse) of a hidden score is inf, not 0.
// Each row is summed by one warp in a fixed order, with no atomics, so the
// result is the same from run to run; a row that sees no key gets exact
// zeros.
//
// What bounds it on this card: 6*D operations per visible (query, key)
// pair (S, dP and dS K, 2*D each) against 4 bytes a value moved, so
// operations, not device memory. All three products run on the tensor
// cores as mma.sync.m16n8k8 TF32 (tf32_mma.cuh), fp32 operands as 3xTF32,
// so the least time is 3 TF32 products of 6*D operations a pair at
// 495 TFLOP/s (chip_smoke.py's bound). Measured on an H100 (PERF.md), the
// kernel reaches ~22 % of that bound at the GPT-2 training shape
// (48, 1024, 64) fp32 causal, held back, like the forward, by instruction
// issue rather than by the tensor cores: the SASS of the default (32, 32)
// fp32 instance at D = 64 holds 3432 instructions, 288 of them mma's and
// ~1160 the integer rounding and subtraction of the hi/lo splits. Splitting
// each K/V tile once a block instead cut the instructions by 15 % but ran
// slower at 8 of the 9 tiles (one more barrier a tile, twice the
// shared-memory loads, less occupancy), so each warp splits its own
// fragments.
//
// Design (it mirrors flash_fwd.cu):
// - Work split: a warp owns 16 query rows (the mma's M); a block has
//   block_q / 16 warps and walks the keys in tiles of block_k. A warp keeps
//   its rows' dQ accumulator (16 x D) in registers, and each thread, which
//   holds rows g and g + 8 of the fragments, keeps their lse and Delta in
//   four registers. Causal blocks stop at the last key any of their rows
//   can see, and a warp skips the tiles past its own rows' last visible key.
// - Q and G are stationary for the whole key loop, so each warp splits its
//   rows once. G's split A fragments go to hi/lo TF32 planes in shared
//   memory (hi only for bf16), stored in fragment order: a lane's four A
//   registers of one k-step are 16 contiguous bytes, so an A operand is one
//   conflict-free 16-byte load a plane. Q's stay in registers at D <= 64
//   (64 at D = 64, as the forward holds Q): both in registers would take 128
//   before any accumulator, and both in planes took 7 % longer at the
//   default tile (67,840 bytes of shared memory a block, three blocks an SM,
//   against 51,456 and four). At D = 128 Q goes to planes beside G's where
//   both fit (all tiles but fp32 64 x 64, which re-reads Q from L1 and
//   splits it every tile): re-reading Q at every tile took 1.2-1.4x as long
//   at 7 of the 9 tiles.
// - K/V staging: the forward's two-stage cp.async ring with the tile's key
//   ids (flash_tc.cuh), plain loads for rows that are not 16-byte
//   multiples or operands that are not 16-byte aligned.
// - Three products a key tile, all on register fragments:
//     S   = Q K^T:  b0 = K[key 8nt + g][d 8ks + t], b1 at d + 4 (the
//                   forward's S);
//     dP  = G V^T:  V read as K is read for S;
//     dQ += dS K:   the dS accumulator fragment is the A operand as it
//                   lies, in the forward's permuted key order:
//                     a0 = ds(row g,     key 2t)     -> k-slot t
//                     a1 = ds(row g + 8, key 2t)     -> k-slot t
//                     a2 = ds(row g,     key 2t + 1) -> k-slot t + 4
//                     a3 = ds(row g + 8, key 2t + 1) -> k-slot t + 4
//                   and K is read as the forward reads V:
//                     b0 = K[key 2t][d 8nd + g]     (k-slot t),
//                     b1 = K[key 2t + 1][d 8nd + g] (k-slot t + 4).
//   The padded ring rows keep all three reads free of bank conflicts.
// - Elementwise work on the accumulator fragments, in log2 units: p =
//   2^(s * scale*log2(e) - lse*log2(e)) is one FFMA and one ex2.approx;
//   hidden scores get -inf from a branch-free test (ids zeroed when
//   absent), so p is exactly 0, also in a row whose lse is -1e30. lse is
//   known, so there is no running max, no rescaling and no division:
//   ds = p (dp - Delta), and the scale multiplies dQ once at the end.
// - Accuracy: fp32 operands are split hi + lo and each product summed as
//   lo*hi' + hi*lo' + hi*hi' (3xTF32). bf16, fp16 and fp8 q, k, g and v
//   are exact in TF32, so S and dP take one product each (fp8 K and V tiles
//   are widened to fp16 as they are staged, flash_tc.cuh). ds, though, is
//   an fp32 value (the reference multiplies fp32 ds by k.astype(float32),
//   :628-631): dS K splits ds into hi + lo against K's one exact TF32
//   value, two products.
//   One TF32 rounding of ds would miss the 1e-4 the kernel is held to
//   (tests/test_torch_flash_tc.py shows it on the CPU). dQ is written in
//   the operands' dtype (fp8 with __NV_NOSAT, as XLA's cast).
//
// Tiles are call parameters (the tuner picks them, ROADMAP B's rule):
// block_q query rows a block and block_k keys a tile, each from
// {16, 32, 64}; (32, 32) is the default.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"
#include "tf32_mma.cuh"

namespace {

using mxtt::from_f32;
using mxtt::row_stride;
using mxtt::split_tf32;
using mxtt::stage_bytes;
using mxtt::stage_kv;
using mxtt::staged_t;
using mxtt::to_f32;

// Q's split A fragments stay in registers up to this head-dim class.
constexpr int kQInRegsMaxD = 64;

// Bytes of one operand's planes in a block: hi and lo (fp32) or hi (the
// 2- and 1-byte types),
// one 32-bit TF32 word a value, kBlockQ rows of kD.
template <typename T, int kD, int kBlockQ>
__host__ __device__ constexpr size_t plane_bytes() {
  return (std::is_same<T, float>::value ? 2 : 1) * sizeof(unsigned) *
         kBlockQ * kD;
}

// Where Q is not held in registers (D = 128), whether its planes fit beside
// the ring and G's in the 227 KB a block may have (all but fp32 64 x 64).
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr bool q_planes() {
  return kD > kQInRegsMaxD && 2 * stage_bytes<staged_t<T>, kD, kBlockK>() +
                            2 * plane_bytes<T, kD, kBlockQ>() <=
                        232448;
}

// Dynamic shared memory of a block: the K/V ring, G's planes and, where
// they fit at D = 128, Q's.
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * stage_bytes<staged_t<T>, kD, kBlockK>() +
         (q_planes<T, kD, kBlockQ, kBlockK>() ? 2 : 1) *
             plane_bytes<T, kD, kBlockQ>();
}

template <typename T>
__device__ __forceinline__ float row_at(const T* base, int r, int d, int Tq,
                                        int D) {
  return (r < Tq && d < D) ? to_f32(base[(size_t)r * D + d]) : 0.f;
}

// The A fragment of rows r0, r0 + 8 of a (Tq, D) operand for k-step ks
// (dims 8ks..8ks+7), split into kSplit products' operands.
template <typename T, int kSplit>
__device__ __forceinline__ void load_a(const T* base, int r0, int ks, int t,
                                       int Tq, int D, unsigned (&ah)[4],
                                       unsigned (&al)[4]) {
  const int d = ks * 8 + t;
  split_tf32<kSplit>(row_at(base, r0, d, Tq, D), ah[0], al[0]);
  split_tf32<kSplit>(row_at(base, r0 + 8, d, Tq, D), ah[1], al[1]);
  split_tf32<kSplit>(row_at(base, r0, d + 4, Tq, D), ah[2], al[2]);
  split_tf32<kSplit>(row_at(base, r0 + 8, d + 4, Tq, D), ah[3], al[3]);
}

__device__ __forceinline__ void to_regs(const uint4& v, unsigned (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// T: the operands' dtype; kD: the head-dim class (16, 32, 64, 128) the
// fragments cover.
template <typename T, int kD, int kBlockQ, int kBlockK>
__global__ void __launch_bounds__(kBlockQ * 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ gout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, T* __restrict__ dq,
                        int H, int Tq, int Tk, int D, float scale, int causal,
                        int vec) {
  static_assert(kBlockQ % 16 == 0 && kBlockK % 8 == 0 && kD % 8 == 0,
                "tiles of the m16n8k8 steps");
  using S = staged_t<T>;                 // K/V tiles in shared memory
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSplit = kF32 ? 3 : 1;    // TF32 products of S and dP
  constexpr int kWarps = kBlockQ / 16;
  constexpr int kThreads = kBlockQ * 2;
  constexpr int kStride = row_stride<S, kD>();
  constexpr int kDSteps = kD / 8;         // k-steps of S, dP; n-tiles of dQ
  constexpr int kKeySteps = kBlockK / 8;  // n-tiles of S, dP; k-steps of dQ
  constexpr bool kQInRegs = kD <= kQInRegsMaxD;
  constexpr bool kQPlanes = q_planes<T, kD, kBlockQ, kBlockK>();
  constexpr int kP = kF32 ? 2 : 1;        // planes an operand: hi (and lo)
  constexpr size_t kStage = stage_bytes<S, kD, kBlockK>();
  extern __shared__ __align__(16) unsigned char smem[];

  const float kNegInf = __int_as_float(0xff800000);
  constexpr float kLog2e = 1.4426950408889634f;
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
  const T* gbase = gout + (size_t)bh * Tq * D;
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
  // scores and lse in log2 units, so p = 2^(s2 - lse2) is one ex2
  const float scale2 = scale * kLog2e;
  const size_t row0 = (size_t)bh * Tq + r0;
  const float lse0 = r0 < Tq ? lse[row0] * kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lse[row0 + 8] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? delta[row0] : 0.f;
  const float dl1 = r1 < Tq ? delta[row0 + 8] : 0.f;

  auto k_tile = [&](int s) {
    return reinterpret_cast<S*>(smem + s * kStage);
  };
  auto v_tile = [&](int s) { return k_tile(s) + kBlockK * kStride; };
  auto ks_tile = [&](int s) {
    return reinterpret_cast<int*>(k_tile(s) + 2 * kBlockK * kStride);
  };
  // plane p (G: 0 hi, 1 lo; Q: kP hi, kP + 1 lo) of this lane, k-step ks
  uint4* planes = reinterpret_cast<uint4*>(smem + 2 * kStage);
  auto plane = [&](int p, int ks) -> uint4& {
    return planes[((p * kWarps + warp) * kDSteps + ks) * 32 + lane];
  };
  // split once: Q's A fragments into registers (kQInRegs) or planes
  // (kQPlanes), G's into planes (each warp splits its own rows; the loop's
  // first __syncthreads() orders these stores before the reads)
  unsigned qh[kQInRegs ? kDSteps : 1][4], ql[kQInRegs ? kDSteps : 1][4];
  auto to_planes = [&](const T* base, int p, int ks) {
    unsigned h[4], l[4];
    load_a<T, kSplit>(base, r0, ks, t, Tq, D, h, l);
    plane(p, ks) = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kF32) plane(p + 1, ks) = make_uint4(l[0], l[1], l[2], l[3]);
  };
  if (w0 < Tq) {
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      if constexpr (kQInRegs)
        load_a<T, kSplit>(qbase, r0, ks, t, Tq, D, qh[ks], ql[ks]);
      if constexpr (kQPlanes) to_planes(qbase, kP, ks);
      to_planes(gbase, 0, ks);
    }
  }
  // an operand's A fragment for k-step ks from its planes (p: hi)
  auto from_planes = [&](int p, int ks, unsigned(&ah)[4], unsigned(&al)[4]) {
    to_regs(plane(p, ks), ah);
    if constexpr (kF32) {
      to_regs(plane(p + 1, ks), al);
    } else {
      al[0] = al[1] = al[2] = al[3] = 0u;
    }
  };
  // the A fragments of Q and G for k-step ks
  auto a_frags = [&](int ks, unsigned(&qah)[4], unsigned(&qal)[4],
                     unsigned(&gah)[4], unsigned(&gal)[4]) {
    if constexpr (kQInRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qah[i] = qh[ks][i];
        qal[i] = ql[ks][i];
      }
    } else if constexpr (kQPlanes) {
      from_planes(kP, ks, qah, qal);
    } else {
      load_a<T, kSplit>(qbase, r0, ks, t, Tq, D, qah, qal);
    }
    from_planes(0, ks, gah, gal);
  };

  // dQ n-tile nd holds dims 8nd + 2t, 8nd + 2t + 1 of rows r0 (acc[nd][0..1])
  // and r1 (acc[nd][2..3])
  float acc[kDSteps][4];
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

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
      const S* k_s = k_tile(cur);
      const S* v_s = v_tile(cur);
      const int* ks_s = ks_tile(cur);

      // -- S = Q K^T and dP = G V^T: rows r0, r1 x keys kb + 8nt + 2t (+1)
      // Each k-step loads and splits its K and V fragments first, then
      // issues the products in passes over the n-tiles (the small ones
      // first), so consecutive mma's are independent.
      float s[kKeySteps][4], dp[kKeySteps][4];
#pragma unroll
      for (int nt = 0; nt < kKeySteps; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        unsigned qah[4], qal[4], gah[4], gal[4];
        a_frags(ks, qah, qal, gah, gal);
        // B = K^T (V^T): b0 = K[key 8nt + g][d 8ks + t], b1 at d + 4
        unsigned kh[kKeySteps][2], kl[kKeySteps][2];
        unsigned vh[kKeySteps][2], vl[kKeySteps][2];
#pragma unroll
        for (int nt = 0; nt < kKeySteps; ++nt) {
          const int at = (nt * 8 + g) * kStride + ks * 8 + t;
          split_tf32<kSplit>(to_f32(k_s[at]), kh[nt][0], kl[nt][0]);
          split_tf32<kSplit>(to_f32(k_s[at + 4]), kh[nt][1], kl[nt][1]);
          split_tf32<kSplit>(to_f32(v_s[at]), vh[nt][0], vl[nt][0]);
          split_tf32<kSplit>(to_f32(v_s[at + 4]), vh[nt][1], vl[nt][1]);
        }
        if constexpr (kSplit == 3) {
#pragma unroll
          for (int nt = 0; nt < kKeySteps; ++nt) {
            mxtt::mma_tf32(s[nt], qal, kh[nt][0], kh[nt][1]);
            mxtt::mma_tf32(dp[nt], gal, vh[nt][0], vh[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < kKeySteps; ++nt) {
            mxtt::mma_tf32(s[nt], qah, kl[nt][0], kl[nt][1]);
            mxtt::mma_tf32(dp[nt], gah, vl[nt][0], vl[nt][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kKeySteps; ++nt) {
          mxtt::mma_tf32(s[nt], qah, kh[nt][0], kh[nt][1]);
          mxtt::mma_tf32(dp[nt], gah, vh[nt][0], vh[nt][1]);
        }
      }

      // -- dS = P (dP - Delta) in place of s; hidden scores -> -inf -> p = 0
      // (branch-free; ids of keys 2t, 2t + 1 in one 8-byte load)
#pragma unroll
      for (int nt = 0; nt < kKeySteps; ++nt) {
        const int j = kb + nt * 8 + 2 * t;
        const int2 kid = *reinterpret_cast<const int2*>(ks_s + nt * 8 + 2 * t);
        const float x0 = (j <= lim0 && kid.x == qs0)
                             ? fmaf(s[nt][0], scale2, -lse0) : kNegInf;
        const float x1 = (j < lim0 && kid.y == qs0)
                             ? fmaf(s[nt][1], scale2, -lse0) : kNegInf;
        const float x2 = (j <= lim1 && kid.x == qs1)
                             ? fmaf(s[nt][2], scale2, -lse1) : kNegInf;
        const float x3 = (j < lim1 && kid.y == qs1)
                             ? fmaf(s[nt][3], scale2, -lse1) : kNegInf;
        s[nt][0] = mxtt::exp2_approx(x0) * (dp[nt][0] - dl0);
        s[nt][1] = mxtt::exp2_approx(x1) * (dp[nt][1] - dl0);
        s[nt][2] = mxtt::exp2_approx(x2) * (dp[nt][2] - dl1);
        s[nt][3] = mxtt::exp2_approx(x3) * (dp[nt][3] - dl1);
      }

      // -- dQ += dS K, dS straight from its accumulator fragments ---------
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        // ds is fp32 in both dtypes: always hi + lo
        unsigned ah[4], al[4];
        split_tf32<3>(s[kk][0], ah[0], al[0]);  // k-slot t
        split_tf32<3>(s[kk][2], ah[1], al[1]);  // k-slot t
        split_tf32<3>(s[kk][1], ah[2], al[2]);  // k-slot t + 4
        split_tf32<3>(s[kk][3], ah[3], al[3]);  // k-slot t + 4
        // b0 = K[key 2t][d 8nd + g] (k-slot t), b1 = K[key 2t + 1] (t + 4)
        const S* kr = k_s + (kk * 8 + 2 * t) * kStride + g;
        unsigned bh[kDSteps][2], bl[kDSteps][2];
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd) {
          split_tf32<kSplit>(to_f32(kr[nd * 8]), bh[nd][0], bl[nd][0]);
          split_tf32<kSplit>(to_f32(kr[kStride + nd * 8]), bh[nd][1],
                             bl[nd][1]);
        }
        // passes over the n-tiles, as above: ds lo * K hi, (fp32) ds hi *
        // K lo, then hi * hi
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
          mxtt::mma_tf32(acc[nd], al, bh[nd][0], bh[nd][1]);
        if constexpr (kSplit == 3) {
#pragma unroll
          for (int nd = 0; nd < kDSteps; ++nd)
            mxtt::mma_tf32(acc[nd], ah, bl[nd][0], bl[nd][1]);
        }
#pragma unroll
        for (int nd = 0; nd < kDSteps; ++nd)
          mxtt::mma_tf32(acc[nd], ah, bh[nd][0], bh[nd][1]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // -- epilogue: dQ * scale in q's dtype -----------------------------------
  T* dqbase = dq + (size_t)bh * Tq * D;
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd) {
    const int d = nd * 8 + 2 * t;
    if (r0 < Tq) {
      if (d < D) dqbase[(size_t)r0 * D + d] = from_f32<T>(acc[nd][0] * scale);
      if (d + 1 < D)
        dqbase[(size_t)r0 * D + d + 1] = from_f32<T>(acc[nd][1] * scale);
    }
    if (r1 < Tq) {
      if (d < D) dqbase[(size_t)r1 * D + d] = from_f32<T>(acc[nd][2] * scale);
      if (d + 1 < D)
        dqbase[(size_t)r1 * D + d + 1] = from_f32<T>(acc[nd][3] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int *qseg, *kseg;
  void* dq;
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
};

template <typename T, int kD, int kBlockQ, int kBlockK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kD, kBlockQ, kBlockK>;
  constexpr size_t kSmem = smem_bytes<T, kD, kBlockQ, kBlockK>();
  if (kSmem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
  }
  // chunked staging for rows of whole chunks from operands aligned to a
  // chunk (16 bytes; 8 for fp8); anything else stages one element at a time
  const int vec = mxtt::vec_staging<T>(a.D, a.k, a.v);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.BH);
  kernel<<<grid, kBlockQ * 2, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.qseg, a.kseg, static_cast<T*>(a.dq), a.H, a.Tq, a.Tk, a.D, a.scale,
      a.causal, vec);
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

// The call's element dtype code among the library's instances.
template <typename... Ts>
cudaError_t dispatch_dtype(mxtt::TypeList<Ts...>, const Args& a, int dtype,
                           int block_q, int block_k, cudaStream_t s) {
  cudaError_t r = cudaErrorInvalidValue;
  (void)((dtype == mxtt::kCode<Ts> &&
          (r = dispatch<Ts>(a, block_q, block_k, s), true)) || ...);
  return r;
}

}  // namespace

// q, g (BH, Tq, D); k, v (BH, Tk, D), contiguous, all of one dtype (the code
// ``dtype``: one of the library's mxtt::Instances); float32
// lse and delta (BH, Tq); qseg (BH / H, Tq) and kseg (BH / H, Tk) int32, or
// both null; dq (BH, Tq, D) in the operands' dtype. block_q, block_k: the
// tile, each 16, 32 or 64. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int mxtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const float* lse,
                                 const float* delta, const int* qseg,
                                 const int* kseg, void* dq, int BH, int H,
                                 int Tq, int Tk, int D, float scale,
                                 int causal, int dtype, int block_q,
                                 int block_k, void* stream) {
  if (BH < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || BH % H != 0 ||
      BH > 65535 || (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, delta, qseg, kseg, dq, BH, H, Tq, Tk, D,
               scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(mxtt::Instances{}, a, dtype, block_q, block_k,
                        s);
}
