// Flash-attention backward, dK/dV, on Hopper's tensor cores (sm_90a).
//
// Built as three libraries: flash_bwd.cu (float32, bfloat16),
// flash_bwd_f16.cu (float16) and flash_bwd_f8.cu (the two fp8 formats)
// each name their element types (mxtt::Instances) and include this file.
//
// Replaces the Pallas TPU kernel _flash_bwd_dkv_kernel
// (mxnet_tpu/ops/pallas_kernels.py:529-584), launched there by
// _flash_bwd_tpu (:638-740), in its plain and segment-id forms. The dQ
// half of the backward is flash_bwd_dq.cu, whose design this kernel
// mirrors with the roles of queries and keys swapped.
//
// With the forward's fp32 log-sum-exp lse_i (-1e30 for a row that sees no
// key) and Delta_i = sum_d g_id o_id (fp32, computed by the caller as the
// reference does at :647-648), for each fused batch-head bh (batch
// b = bh / H), query i and key j:
//   s_ij    = (q_i . k_j) * scale                                     fp32
//   visible = i < Tq && j < Tk          (the ragged edges)
//           && (!causal || j <= i + (Tk - Tq))              (bottom-right)
//           && (!seg    || qseg[b, i] == kseg[b, j])
//   p_ij    = visible ? exp(s_ij - lse_i) : 0
//   dp_ij   = g_i . v_j
//   ds_ij   = p_ij (dp_ij - Delta_i) * scale
//   dV_j    = sum_i p_ij g_i,   dK_j = sum_i ds_ij q_i
// p is forced to 0 under the combined mask, never computed and then
// masked: with lse = -1e30, exp(s - lse) of a hidden score is inf, not 0
// (the reference masks p for the same reason, :565-568). Each key's
// gradients are summed by one warp in a fixed order, with no atomics, so
// the result is the same from run to run; a key that no query sees gets
// exact zeros.
//
// What bounds it on this card: 8*D operations per visible (query, key)
// pair (S, dP, dV and dK, 2*D each) against 4 bytes a value moved, so
// operations, not device memory. All four products run on the tensor
// cores as mma.sync.m16n8k8 TF32 (tf32_mma.cuh), fp32 operands as 3xTF32,
// so the least time is 3 TF32 products of 8*D operations a pair at
// 495 TFLOP/s (chip_smoke.py's bound). Like the forward and dQ, the kernel
// is expected to be bound by instruction issue (per-warp hi/lo splits of
// the walked tiles' fragments) well before the tensor cores.
//
// Design (flash_bwd_dq.cu with queries and keys swapped):
// - Work split: a warp owns 16 keys (the mma's M); a block has
//   block_k / 16 warps and walks the queries in tiles of block_q. A warp
//   keeps its keys' dK and dV accumulators (16 x D each) in registers.
//   Causal blocks start at the first query any of their keys can see, and
//   a warp skips the tiles that none of its keys can see.
// - Sums one tile at a time (fp32): the tensor cores' accumulator
//   truncates on every mma, and dV_j, dK_j sum over all Tq queries, 3 mma's
//   a k-step: summed in the accumulator across a causal T = 1024 (384 adds)
//   the bias reached 7.5e-5 against the float64 answer at |dV| <= 6, more
//   than the plain fp32 version's 1.2e-5 (an H100, PERF.md). So each query
//   tile's sums start from zero in the accumulator and join running sums in
//   shared memory (one float4 a lane an n-tile, in fragment order) by IEEE
//   adds: 3.5e-6 at the cost of 16 KB a block at the default tile. bf16
//   keeps its sums in registers: the bias is ~1e-4 of a value, a sixtieth
//   of one bf16 step.
// - Transposed scores built directly: S^T = K Q^T and dP^T = V G^T, with
//   K and V the stationary A operands, split once a warp. K's split A
//   fragments stay in registers at D <= 64, V's go to hi/lo TF32 planes in
//   shared memory in fragment order (a lane's four A registers of one
//   k-step are 16 contiguous bytes, one conflict-free load a plane; hi only
//   for bf16). At D = 128 K goes to planes beside V's where both fit
//   beside the ring and the fp32 sums, as dQ does with Q and G; where they
//   do not, K (and at fp32 64 x 64 also V) is re-read from L1 and split
//   every tile. fp32 D = 128 spills 8-138 bytes, bf16 D = 128 16 bytes.
// - Q and G tiles are staged by the forward's two-stage cp.async ring
//   (flash_tc.cuh stage_kv, with the query ids), plain loads for rows that
//   are not 16-byte multiples or operands that are not 16-byte aligned;
//   each stage also holds the tile's lse and Delta (cp.async, 4 bytes a
//   value), which the fragments index by column (the query).
// - Four products a query tile, all on register fragments:
//     S^T   = K Q^T:  b0 = Q[query 8nt + g][d 8ks + t], b1 at d + 4 (Q is
//                     read as the forward reads K);
//     dP^T  = V G^T:  G read as Q is read for S^T;
//     dV   += P^T G:  the P^T accumulator fragment is the A operand as it
//                     lies, in the forward's permuted query order
//                       a0 = p(key g,     query 2t)     -> k-slot t
//                       a1 = p(key g + 8, query 2t)     -> k-slot t
//                       a2 = p(key g,     query 2t + 1) -> k-slot t + 4
//                       a3 = p(key g + 8, query 2t + 1) -> k-slot t + 4
//                     and G is read as the forward reads V:
//                       b0 = G[query 2t][d 8nd + g]     (k-slot t),
//                       b1 = G[query 2t + 1][d 8nd + g] (k-slot t + 4);
//     dK   += dS^T Q: the same, dS^T for P^T and Q for G.
//   The padded ring rows keep all four reads free of bank conflicts.
// - Elementwise work on the accumulator fragments, in log2 units: p =
//   2^(s * scale*log2(e) - lse*log2(e)) is one FFMA and one ex2.approx;
//   hidden scores get -inf from a branch-free test (an unsigned range test
//   of the query against the key's causal start and Tq, ids zeroed when
//   absent), so p is exactly 0, also in a row whose lse is -1e30 and in
//   the zero-filled rows past Tq. lse is known: no running max, no
//   rescaling, no division; ds = p (dp - Delta), and the scale multiplies
//   dK once at the end.
// - Accuracy: fp32 operands are split hi + lo and each product summed as
//   lo*hi' + hi*lo' + hi*hi' (3xTF32). bf16, fp16 and fp8 q, k, g and v
//   are exact in TF32, so S^T and dP^T take one product each (fp8 Q and G
//   tiles are widened to fp16 as they are staged, flash_tc.cuh). p and ds,
//   though, are fp32 values (the reference multiplies fp32 p and ds by g
//   and q cast to float32, :570-582): dV and dK split them into hi + lo
//   against G's and Q's one exact TF32 value, two products. One TF32
//   rounding of p or ds would miss the 1e-4 the kernel is held to
//   (tests/test_torch_flash_tc.py shows it on the CPU). dK and dV are written in the operands' dtype
//   (fp8 with __NV_NOSAT: an overflowing gradient gives inf or NaN, which
//   the loss scaler must see, as XLA's cast gives them).
//
// Tiles are call parameters (the tuner picks them, ROADMAP B's rule):
// block_k keys a block and block_q queries a tile, each from
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
using mxtt::stage_kv;
using mxtt::staged_t;
using mxtt::to_f32;

// K's split A fragments stay in registers up to this head-dim class.
constexpr int kKInRegsMaxD = 64;

// Bytes of one ring stage: the Q and G tiles (as staged_t<T>) with their
// query ids (flash_tc.cuh), then the tile's lse and Delta.
template <typename T, int kD, int kBlockQ>
__host__ __device__ constexpr size_t ring_stage_bytes() {
  return mxtt::stage_bytes<staged_t<T>, kD, kBlockQ>() +
         2 * sizeof(float) * kBlockQ;
}

// Bytes of one operand's planes in a block: hi and lo (fp32) or hi (the
// 2- and 1-byte types),
// one 32-bit TF32 word a value, kBlockK rows of kD.
template <typename T, int kD, int kBlockK>
__host__ __device__ constexpr size_t plane_bytes() {
  return (std::is_same<T, float>::value ? 2 : 1) * sizeof(unsigned) *
         kBlockK * kD;
}

// Whether an instance sums each query tile from zero and keeps running
// sums in shared memory (fp32; the 2- and 1-byte types keep their sums in
// registers, whose bias lies well below one of their rounding steps).
template <typename T>
__host__ __device__ constexpr bool tile_sums() {
  return std::is_same<T, float>::value;
}

// Bytes of the running sums of dK and dV in a block, one float4 a lane an
// n-tile.
template <typename T, int kD, int kBlockK>
__host__ __device__ constexpr size_t sum_bytes() {
  return tile_sums<T>() ? 2 * sizeof(float) * kBlockK * kD : 0;
}

// Bytes of the ring and the running sums, which every instance holds.
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr size_t base_bytes() {
  return 2 * ring_stage_bytes<T, kD, kBlockQ>() + sum_bytes<T, kD, kBlockK>();
}

// Whether V's planes fit beside the ring and the sums in the 227 KB a
// block may have (all instances but fp32 D = 128 at 64 x 64, which re-reads
// V from L1 and splits it every tile).
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr bool v_planes() {
  return base_bytes<T, kD, kBlockQ, kBlockK>() +
             plane_bytes<T, kD, kBlockK>() <= 232448;
}

// Where K is not held in registers (D = 128), whether its planes fit beside
// V's too.
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr bool k_planes() {
  return kD > kKInRegsMaxD && v_planes<T, kD, kBlockQ, kBlockK>() &&
         base_bytes<T, kD, kBlockQ, kBlockK>() +
                 2 * plane_bytes<T, kD, kBlockK>() <= 232448;
}

// Dynamic shared memory of a block: the Q/G ring, the fp32 sums, V's planes
// where they fit and, where they fit at D = 128, K's.
template <typename T, int kD, int kBlockQ, int kBlockK>
__host__ __device__ constexpr size_t smem_bytes() {
  return base_bytes<T, kD, kBlockQ, kBlockK>() +
         ((v_planes<T, kD, kBlockQ, kBlockK>() ? 1 : 0) +
          (k_planes<T, kD, kBlockQ, kBlockK>() ? 1 : 0)) *
             plane_bytes<T, kD, kBlockK>();
}

template <typename T>
__device__ __forceinline__ float row_at(const T* base, int r, int d, int n,
                                        int D) {
  return (r < n && d < D) ? to_f32(base[(size_t)r * D + d]) : 0.f;
}

// The A fragment of rows r0, r0 + 8 of an (n, D) operand for k-step ks
// (dims 8ks..8ks+7), split into kSplit products' operands.
template <typename T, int kSplit>
__device__ __forceinline__ void load_a(const T* base, int r0, int ks, int t,
                                       int n, int D, unsigned (&ah)[4],
                                       unsigned (&al)[4]) {
  const int d = ks * 8 + t;
  split_tf32<kSplit>(row_at(base, r0, d, n, D), ah[0], al[0]);
  split_tf32<kSplit>(row_at(base, r0 + 8, d, n, D), ah[1], al[1]);
  split_tf32<kSplit>(row_at(base, r0, d + 4, n, D), ah[2], al[2]);
  split_tf32<kSplit>(row_at(base, r0 + 8, d + 4, n, D), ah[3], al[3]);
}

__device__ __forceinline__ void to_regs(const uint4& v, unsigned (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// acc[nd] += A B over the D n-tiles, A = a p or ds fragment (split hi + lo
// here: fp32 in both dtypes) and B = the staged tile ``x_s`` (G or Q) read
// as the forward reads V: b0 = x[query 8kk + 2t][d 8nd + g], b1 at the
// next query.
template <typename S, int kSplit, int kDSteps, int kStride>
__device__ __forceinline__ void acc_product(float (&acc)[kDSteps][4],
                                            const float (&c)[4],
                                            const S* x_s, int kk, int g,
                                            int t) {
  unsigned ah[4], al[4];
  split_tf32<3>(c[0], ah[0], al[0]);  // k-slot t
  split_tf32<3>(c[2], ah[1], al[1]);  // k-slot t
  split_tf32<3>(c[1], ah[2], al[2]);  // k-slot t + 4
  split_tf32<3>(c[3], ah[3], al[3]);  // k-slot t + 4
  const S* xr = x_s + (kk * 8 + 2 * t) * kStride + g;
  unsigned bh[kDSteps][2], bl[kDSteps][2];
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd) {
    split_tf32<kSplit>(to_f32(xr[nd * 8]), bh[nd][0], bl[nd][0]);
    split_tf32<kSplit>(to_f32(xr[kStride + nd * 8]), bh[nd][1], bl[nd][1]);
  }
  // passes over the n-tiles, the small products first: lo * B hi, (fp32)
  // hi * B lo, then hi * hi
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

// T: the operands' dtype; kD: the head-dim class (16, 32, 64, 128) the
// fragments cover.
template <typename T, int kD, int kBlockQ, int kBlockK>
__global__ void __launch_bounds__(kBlockK * 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ gout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int Tk, int D,
                         float scale, int causal, int vec) {
  static_assert(kBlockK % 16 == 0 && kBlockQ % 8 == 0 && kD % 8 == 0,
                "tiles of the m16n8k8 steps");
  using S = staged_t<T>;                 // Q/G tiles in shared memory
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSplit = kF32 ? 3 : 1;    // TF32 products of S^T and dP^T
  constexpr int kWarps = kBlockK / 16;
  constexpr int kThreads = kBlockK * 2;
  constexpr int kStride = row_stride<S, kD>();
  constexpr int kDSteps = kD / 8;         // k-steps of S^T; n-tiles of dK
  constexpr int kQSteps = kBlockQ / 8;    // n-tiles of S^T; k-steps of dK
  constexpr bool kKInRegs = kD <= kKInRegsMaxD;
  constexpr bool kVPlanes = v_planes<T, kD, kBlockQ, kBlockK>();
  constexpr bool kKPlanes = k_planes<T, kD, kBlockQ, kBlockK>();
  constexpr int kP = kF32 ? 2 : 1;        // planes an operand: hi (and lo)
  constexpr size_t kStage = ring_stage_bytes<T, kD, kBlockQ>();
  constexpr size_t kTiles = mxtt::stage_bytes<S, kD, kBlockQ>();
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
  const int k0 = blockIdx.x * kBlockK;
  const int w0 = k0 + warp * 16;  // the warp's first key
  const int j0 = w0 + g;          // this thread's keys: j0 and j0 + 8
  const int j1 = j0 + 8;
  const int offset = Tk - Tq;
  const bool use_seg = qseg != nullptr;

  // the first query the block stages, and the first any of this warp's
  // keys can see: under causal, query i sees key j iff i >= j - offset
  const int qbeg = causal ? max(k0 - offset, 0) : 0;
  const int wbeg = causal ? w0 - offset : 0;
  const T* qbase = q + (size_t)bh * Tq * D;
  const T* gbase = gout + (size_t)bh * Tq * D;
  const T* kbase = k + (size_t)bh * Tk * D;
  const T* vbase = v + (size_t)bh * Tk * D;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* dl_bh = delta + (size_t)bh * Tq;
  const int* qseg_b = use_seg ? qseg + (size_t)b * Tq : nullptr;
  // without ids every query carries id 0 (the ring's ids are zeroed once
  // below), so the mask below is the same branch-free test either way
  const int ks0 = (use_seg && j0 < Tk) ? kseg[(size_t)b * Tk + j0] : 0;
  const int ks1 = (use_seg && j1 < Tk) ? kseg[(size_t)b * Tk + j1] : 0;
  // key j sees queries i with (unsigned)(i - ilo) < span: i >= its causal
  // start and i < Tq; a key past Tk sees none
  const int ilo0 = causal ? max(j0 - offset, 0) : 0;
  const int ilo1 = causal ? max(j1 - offset, 0) : 0;
  const unsigned span0 = j0 < Tk ? (unsigned)max(Tq - ilo0, 0) : 0u;
  const unsigned span1 = j1 < Tk ? (unsigned)max(Tq - ilo1, 0) : 0u;
  const float scale2 = scale * kLog2e;

  auto q_tile = [&](int s) {
    return reinterpret_cast<S*>(smem + s * kStage);
  };
  auto g_tile = [&](int s) { return q_tile(s) + kBlockQ * kStride; };
  auto qs_tile = [&](int s) {
    return reinterpret_cast<int*>(q_tile(s) + 2 * kBlockQ * kStride);
  };
  auto lse_tile = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kStage + kTiles);
  };
  auto dl_tile = [&](int s) { return lse_tile(s) + kBlockQ; };
  // stage the query tile at qb: Q, G and the ids by stage_kv, lse and
  // Delta by 4-byte cp.async (zero past Tq)
  auto stage = [&](int s, int qb) {
    stage_kv<T, kD, kBlockQ, kThreads>(q_tile(s), g_tile(s), qs_tile(s),
                                       qbase, gbase, qseg_b, qb, Tq, D, vec);
    for (int i = tid; i < kBlockQ; i += kThreads) {
      const int qi = qb + i;
      const int at = qi < Tq ? qi : 0;
      mxtt::cp_async4(lse_tile(s) + i, lse_bh + at, qi < Tq);
      mxtt::cp_async4(dl_tile(s) + i, dl_bh + at, qi < Tq);
    }
  };
  // the fp32 running sums: dK (which = 0) and dV (1), n-tile nd, this lane
  float4* sums = reinterpret_cast<float4*>(smem + 2 * kStage);
  auto sum = [&](int which, int nd) -> float4& {
    return sums[((which * kWarps + warp) * kDSteps + nd) * 32 + lane];
  };
  // plane p (V: 0 hi, 1 lo; K: kP hi, kP + 1 lo) of this lane, k-step ks
  uint4* planes = reinterpret_cast<uint4*>(
      smem + base_bytes<T, kD, kBlockQ, kBlockK>());
  auto plane = [&](int p, int ks) -> uint4& {
    return planes[((p * kWarps + warp) * kDSteps + ks) * 32 + lane];
  };
  // split once: K's A fragments into registers (kKInRegs) or planes
  // (kKPlanes), V's into planes (each lane reads back only what it wrote)
  unsigned kh[kKInRegs ? kDSteps : 1][4], kl[kKInRegs ? kDSteps : 1][4];
  auto to_planes = [&](const T* base, int p, int ks) {
    unsigned h[4], l[4];
    load_a<T, kSplit>(base, j0, ks, t, Tk, D, h, l);
    plane(p, ks) = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kF32) plane(p + 1, ks) = make_uint4(l[0], l[1], l[2], l[3]);
  };
  if (w0 < Tk) {
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      if constexpr (kKInRegs)
        load_a<T, kSplit>(kbase, j0, ks, t, Tk, D, kh[ks], kl[ks]);
      if constexpr (kKPlanes) to_planes(kbase, kP, ks);
      if constexpr (kVPlanes) to_planes(vbase, 0, ks);
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
  // the A fragments of K and V for k-step ks
  auto a_frags = [&](int ks, unsigned(&kah)[4], unsigned(&kal)[4],
                     unsigned(&vah)[4], unsigned(&val)[4]) {
    if constexpr (kKInRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kah[i] = kh[ks][i];
        kal[i] = kl[ks][i];
      }
    } else if constexpr (kKPlanes) {
      from_planes(kP, ks, kah, kal);
    } else {
      load_a<T, kSplit>(kbase, j0, ks, t, Tk, D, kah, kal);
    }
    if constexpr (kVPlanes) {
      from_planes(0, ks, vah, val);
    } else {
      load_a<T, kSplit>(vbase, j0, ks, t, Tk, D, vah, val);
    }
  };

  // dK (dV) n-tile nd holds dims 8nd + 2t, 8nd + 2t + 1 of keys j0
  // (acc[nd][0..1]) and j1 (acc[nd][2..3])
  float dka[kDSteps][4], dva[kDSteps][4];
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;
  }

  // this tile's sums join the running sums by IEEE adds, and the
  // accumulator restarts from zero
  auto flush = [&](float(&acc)[kDSteps][4], int which, bool first) {
#pragma unroll
    for (int nd = 0; nd < kDSteps; ++nd) {
      float4& r = sum(which, nd);
      const float4 o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : r;
      r = make_float4(o.x + acc[nd][0], o.y + acc[nd][1], o.z + acc[nd][2],
                      o.w + acc[nd][3]);
      acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    }
  };
  bool first = true;  // no tile of this warp has run yet

  if (!use_seg) {
    for (int i = tid; i < kBlockQ; i += kThreads)
      qs_tile(0)[i] = qs_tile(1)[i] = 0;
  }
  if (qbeg < Tq) stage(0, qbeg);
  mxtt::cp_async_commit();
  int cur = 0;
  for (int qb = qbeg; qb < Tq; qb += kBlockQ, cur ^= 1) {
    // the next tile loads into the other stage while this one multiplies
    if (qb + kBlockQ < Tq) stage(cur ^ 1, qb + kBlockQ);
    mxtt::cp_async_commit();
    mxtt::cp_async_wait<1>();  // every group but the one just issued
    __syncthreads();

    if (w0 < Tk && qb + kBlockQ > wbeg) {
      const S* q_s = q_tile(cur);
      const S* g_s = g_tile(cur);
      const int* qs_s = qs_tile(cur);
      const float* lse_s = lse_tile(cur);
      const float* dl_s = dl_tile(cur);

      // -- S^T = K Q^T and dP^T = V G^T: keys j0, j1 x queries
      // qb + 8nt + 2t (+1). Each k-step loads and splits its Q and G
      // fragments first, then issues the products in passes over the
      // n-tiles (the small ones first), so consecutive mma's are
      // independent.
      float s[kQSteps][4], dp[kQSteps][4];
#pragma unroll
      for (int nt = 0; nt < kQSteps; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        unsigned kah[4], kal[4], vah[4], val[4];
        a_frags(ks, kah, kal, vah, val);
        // B = Q^T (G^T): b0 = Q[query 8nt + g][d 8ks + t], b1 at d + 4
        unsigned qh[kQSteps][2], ql[kQSteps][2];
        unsigned gh[kQSteps][2], gl[kQSteps][2];
#pragma unroll
        for (int nt = 0; nt < kQSteps; ++nt) {
          const int at = (nt * 8 + g) * kStride + ks * 8 + t;
          split_tf32<kSplit>(to_f32(q_s[at]), qh[nt][0], ql[nt][0]);
          split_tf32<kSplit>(to_f32(q_s[at + 4]), qh[nt][1], ql[nt][1]);
          split_tf32<kSplit>(to_f32(g_s[at]), gh[nt][0], gl[nt][0]);
          split_tf32<kSplit>(to_f32(g_s[at + 4]), gh[nt][1], gl[nt][1]);
        }
        if constexpr (kSplit == 3) {
#pragma unroll
          for (int nt = 0; nt < kQSteps; ++nt) {
            mxtt::mma_tf32(s[nt], kal, qh[nt][0], qh[nt][1]);
            mxtt::mma_tf32(dp[nt], val, gh[nt][0], gh[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < kQSteps; ++nt) {
            mxtt::mma_tf32(s[nt], kah, ql[nt][0], ql[nt][1]);
            mxtt::mma_tf32(dp[nt], vah, gl[nt][0], gl[nt][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kQSteps; ++nt) {
          mxtt::mma_tf32(s[nt], kah, qh[nt][0], qh[nt][1]);
          mxtt::mma_tf32(dp[nt], vah, gh[nt][0], gh[nt][1]);
        }
      }

      // -- P^T in place of s and dS^T = P^T (dP^T - Delta) in place of dp;
      // hidden scores -> -inf -> p = 0 (branch-free; ids, lse and Delta of
      // queries 2t, 2t + 1 in one 8-byte load each)
#pragma unroll
      for (int nt = 0; nt < kQSteps; ++nt) {
        const int c = nt * 8 + 2 * t;
        const int i = qb + c;
        const int2 qid = *reinterpret_cast<const int2*>(qs_s + c);
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + c);
        const float l0 = ls.x * kLog2e;
        const float l1 = ls.y * kLog2e;
        const float x0 = ((unsigned)(i - ilo0) < span0 && qid.x == ks0)
                             ? fmaf(s[nt][0], scale2, -l0) : kNegInf;
        const float x1 = ((unsigned)(i + 1 - ilo0) < span0 && qid.y == ks0)
                             ? fmaf(s[nt][1], scale2, -l1) : kNegInf;
        const float x2 = ((unsigned)(i - ilo1) < span1 && qid.x == ks1)
                             ? fmaf(s[nt][2], scale2, -l0) : kNegInf;
        const float x3 = ((unsigned)(i + 1 - ilo1) < span1 && qid.y == ks1)
                             ? fmaf(s[nt][3], scale2, -l1) : kNegInf;
        s[nt][0] = mxtt::exp2_approx(x0);
        s[nt][1] = mxtt::exp2_approx(x1);
        s[nt][2] = mxtt::exp2_approx(x2);
        s[nt][3] = mxtt::exp2_approx(x3);
        dp[nt][0] = s[nt][0] * (dp[nt][0] - dl.x);
        dp[nt][1] = s[nt][1] * (dp[nt][1] - dl.y);
        dp[nt][2] = s[nt][2] * (dp[nt][2] - dl.x);
        dp[nt][3] = s[nt][3] * (dp[nt][3] - dl.y);
      }

      // -- dV += P^T G and dK += dS^T Q, straight from the fragments ------
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        acc_product<S, kSplit, kDSteps, kStride>(dva, s[kk], g_s, kk, g, t);
        acc_product<S, kSplit, kDSteps, kStride>(dka, dp[kk], q_s, kk, g, t);
      }
      if constexpr (tile_sums<T>()) {
        flush(dka, 0, first);
        flush(dva, 1, first);
      }
      first = false;
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // -- epilogue: dK * scale and dV in k's dtype ---------------------------
  if constexpr (tile_sums<T>()) {
    if (!first) {
#pragma unroll
      for (int nd = 0; nd < kDSteps; ++nd) {
        const float4 a = sum(0, nd), c = sum(1, nd);
        dka[nd][0] = a.x, dka[nd][1] = a.y, dka[nd][2] = a.z, dka[nd][3] = a.w;
        dva[nd][0] = c.x, dva[nd][1] = c.y, dva[nd][2] = c.z, dva[nd][3] = c.w;
      }
    }
  }
  T* dkbase = dk + (size_t)bh * Tk * D;
  T* dvbase = dv + (size_t)bh * Tk * D;
#pragma unroll
  for (int nd = 0; nd < kDSteps; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = e < 2 ? j0 : j1;
      const int d = nd * 8 + 2 * t + (e & 1);
      if (j < Tk && d < D) {
        dkbase[(size_t)j * D + d] = from_f32<T>(dka[nd][e] * scale);
        dvbase[(size_t)j * D + d] = from_f32<T>(dva[nd][e]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int *qseg, *kseg;
  void *dk, *dv;
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
};

template <typename T, int kD, int kBlockQ, int kBlockK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kD, kBlockQ, kBlockK>;
  constexpr size_t kSmem = smem_bytes<T, kD, kBlockQ, kBlockK>();
  if (kSmem > 48 * 1024) {
    // once per instantiation, before its first launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
  }
  // chunked staging for rows of whole chunks from operands aligned to a
  // chunk (16 bytes; 8 for fp8); anything else stages one element at a time
  const int vec = mxtt::vec_staging<T>(a.D, a.q, a.g);
  const dim3 grid((a.Tk + kBlockK - 1) / kBlockK, a.BH);
  kernel<<<grid, kBlockK * 2, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.qseg, a.kseg, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Tq, a.Tk, a.D, a.scale, a.causal, vec);
  return cudaGetLastError();
}

template <typename T, int kD, int kBlockK>
cudaError_t dispatch_q(const Args& a, int block_q, cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<T, kD, 16, kBlockK>(a, s);
    case 32: return launch<T, kD, 32, kBlockK>(a, s);
    case 64: return launch<T, kD, 64, kBlockK>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int kD>
cudaError_t dispatch_k(const Args& a, int block_q, int block_k,
                       cudaStream_t s) {
  switch (block_k) {
    case 16: return dispatch_q<T, kD, 16>(a, block_q, s);
    case 32: return dispatch_q<T, kD, 32>(a, block_q, s);
    case 64: return dispatch_q<T, kD, 64>(a, block_q, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int block_q, int block_k,
                     cudaStream_t s) {
  if (a.D <= 16) return dispatch_k<T, 16>(a, block_q, block_k, s);
  if (a.D <= 32) return dispatch_k<T, 32>(a, block_q, block_k, s);
  if (a.D <= 64) return dispatch_k<T, 64>(a, block_q, block_k, s);
  if (a.D <= 128) return dispatch_k<T, 128>(a, block_q, block_k, s);
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

// q, g (BH, Tq, D); k, v (BH, Tk, D), contiguous and of one dtype (the code
// ``dtype``: one of the library's mxtt::Instances); float32
// lse and delta (BH, Tq); qseg (BH / H, Tq) and kseg (BH / H, Tk) int32, or
// both null; dk, dv (BH, Tk, D) in the operands' dtype; the tile block_q,
// block_k, each 16, 32 or 64 (the block owns block_k keys and walks
// block_q queries at a time). Launches one kernel on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int mxtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const float* lse,
                                  const float* delta, const int* qseg,
                                  const int* kseg, void* dk, void* dv, int BH,
                                  int H, int Tq, int Tk, int D, float scale,
                                  int causal, int dtype, int block_q,
                                  int block_k, void* stream) {
  if (BH < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || BH % H != 0 ||
      BH > 65535 || (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, delta, qseg, kseg, dk, dv,
               BH, H, Tq, Tk, D, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dtype(mxtt::Instances{}, a, dtype, block_q, block_k,
                        s);
}
