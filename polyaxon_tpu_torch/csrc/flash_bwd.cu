// Flash attention backward for one block: Hopper (sm_90a).
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// polyaxon_tpu/parallel/flash.py (called there through `flash_block_bwd`).
// Same function, from q, do [BH, Tq, d], k, v [BH, Tk, d] (bf16 or f32,
// contiguous, d in {64, 128}) and the forward's lse and delta = rowsum(do o)
// [BH, Tq] (f32):
//   p  = exp(s * sm_scale - lse), s = q k^T, masked to 0 (causal: q and k
//        share one global offset; a row whose lse is -inf saw no key and
//        contributes nothing)
//   ds = p (do v^T - delta) sm_scale
//   dq = ds k            (ds rounded to k's dtype, as flash.py:210)
//   dv = p^T do          (p rounded to do's dtype, as flash.py:249)
//   dk = ds^T q          (ds rounded to q's dtype, as flash.py:258)
// all sums in float32, dq/dk/dv written as float32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at
// the training shape of the 671M model (BH = 20 x 32, T = 1024, d = 64,
// bf16, causal): the dq pass reads q, k, v, do (4 x 83.9 MB) and lse, delta
// (2 x 2.6 MB) and writes dq (167.8 MB), 508.6 MB or 151.8 us, against 129.0
// GFLOP of products (three per visible pair) or 130.4 us: bound by bytes.
// The dk/dv pass reads the same and writes dk, dv (2 x 167.8 MB), 676.3 MB
// or 201.9 us, against 172.0 GFLOP (four products) or 173.9 us: bytes, with
// the products close behind.
//
// Design.  The TPU runs each pass as a grid whose innermost axis is
// sequential and carries the accumulator in VMEM scratch; Hopper blocks run
// in no order, so that axis becomes a loop inside one thread block, and the
// accumulators stay in registers.  Neither pass needs atomics, and both are
// deterministic:
//   dq pass:   one block per (bh, q tile).  It walks the 64-row k/v tiles
//              up to the diagonal and keeps its dq rows in registers.
//   dk/dv pass: one block per (bh, 64-row k tile).  It walks the q/do tiles
//              from the diagonal on and keeps its dk and dv rows in
//              registers.
// Each pass picks its kernel by dtype (dispatch by type, not a fallback):
// bf16 inputs run the tensor-core kernels, float32 inputs the FMA kernels
// (tensor cores would need TF32 there, a different result).
//
// The mma sums of s and dp run in another order than the plain version's,
// so a p or ds within a few float32 ulps of a bf16 rounding boundary could
// round the other way; both tensor-core kernels screen for those and sum
// them again in the plain version's order (`resum_near_ties`), so each
// value they round of 2^-7 or more rounds as there, and the grads differ
// from the plain version by summation order and by flips of smaller
// values, each at most 2^-15 |k|, |q| or |do|.
//
// dq pass:
//   bf16, `flash_bwd_dq_bf16_kernel` (mma.sync): 4 warps; 128-row q tiles
//     at d = 64 (two m16 tiles a warp, so that each K and V fragment read
//     from shared memory feeds two products) and 64 at d = 128 (one).  The
//     q and do tiles are staged once; the q rows stay in registers as A
//     fragments, the do rows are read again for each chunk of keys.  K and
//     V tiles arrive through cp.async in a two-stage ring, tile j + 1 in
//     flight while tile j is used.  S = Q K^T and dP = dO V^T are
//     mma.sync m16n8k16 bf16 products with q rows as mma rows (K and V as B
//     fragments through ldmatrix), taken over chunks of 32 keys at d = 64
//     and 64 at d = 128, so that s and dp of a chunk are 32 registers a
//     lane each.  ds = p (dp - delta) scale is screened (ds only: the pass
//     rounds nothing else) and converted in registers into the bf16 A
//     fragment of dQ += dS K, K through ldmatrix.trans: that conversion is
//     the TPU kernel's ds.astype(k.dtype), and ds never goes through shared
//     memory.  Each lane reads lse and delta of its rows once.  Causal q
//     tiles are scheduled longest first.  What holds it back: the screen
//     and the rounds of re-summing (about a quarter of its time), mma.sync at
//     about two thirds of the wgmma rate, and the 128-row q tiles at
//     d = 64, which span two key tiles on the diagonal, where part of each
//     warp's scores are masked.
//   float32, `flash_bwd_dq_kernel`: each of the 8 warps owns 8 rows of a
//     64-row q tile; a lane holds two columns of the 64 x 64 score tile for
//     each, writes its ds values to a shared tile, and then owns d / 32 dq
//     columns of each of its rows.  Tiles are staged in shared memory,
//     padded by one word where read one row per lane, and the products are
//     plain float32 FMAs: bound by its own instruction rate.  It serves the
//     small float32 correctness runs.
//
// dk/dv pass:
//   bf16, `flash_bwd_dkv_bf16_kernel` (mma.sync): 4 warps of 16 key rows.
//     K and V are staged once as bf16; the q, do, lse and delta tiles arrive
//     through cp.async in a two-stage ring, tile j + 1 in flight while tile
//     j is used.  The score tiles are computed transposed, s^T = K Q^T and
//     dp^T = V dO^T, as mma.sync m16n8k16 bf16 products (ldmatrix-fed,
//     shared rows padded by 16 bytes), so their accumulator fragments
//     convert in registers into the bf16 A fragments of dV += P^T dO and
//     dK += dS^T Q: that conversion is the TPU kernel's rounding of p to
//     do's dtype and of ds to q's dtype, and neither tile goes through
//     shared memory.  dO and Q enter those products through
//     ldmatrix.trans.  It screens both p and ds.  q tiles
//     are 64 rows at d = 64 and 32 at d = 128, so the dK and dV
//     accumulators (d registers a lane together) sit beside the score
//     tiles without spills; K and V fragments are re-read from shared
//     memory for each q tile.  With k tiles of 64 rows the first q tile a
//     causal block visits is (k0 / BQ) * BQ.  What holds it back now: the
//     screen and the serial FMA chains of the re-summed pairs (a warp's
//     round stalls its block at the tile's barrier), mma.sync at about two
//     thirds of the wgmma rate, and the dk/dv pass and the dq pass each
//     read q, k, v and do (a fused single pass would read them once).
//   float32, `flash_bwd_dkv_kernel`: the dq pass's FMA design transposed
//     (a lane holds two q columns of each of its warp's 8 key rows), for
//     the small float32 correctness runs.
// The ragged tail (T not a multiple of the tile) is masked in the kernels:
// out-of-range rows load as zeros and are masked out of p (lse = -inf for
// query rows past the end), so they add nothing, and are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

namespace {

// The float32 FMA kernels.  With float32 inputs the TPU kernel's roundings
// (ds to k's and q's dtype, p to do's) change nothing.
constexpr int kBlockQ = 64;  // q rows per tile
constexpr int kBlockK = 64;  // k rows per tile (the causal loop bounds rely on kBlockQ == kBlockK)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 64 / kWarps;

// p = exp(s * scale - lse) where kept; 0 where masked or where the row saw
// no key (lse = -inf, where exp would overflow).
__device__ __forceinline__ float prob(float s, float lse, bool keep, float scale) {
  return (keep && lse != -CUDART_INF_F) ? expf(s * scale - lse) : 0.f;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, do tiles [BQ][D]; k, v tiles [BK][D+1]; ds tile [BQ][BK]; lse, delta [BQ]
  return sizeof(float) *
         (2 * kBlockQ * D + 2 * kBlockK * (D + 1) + kBlockQ * kBlockK + 2 * kBlockQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v tiles [BK][D]; q, do tiles [BQ][D+1]; p, ds tiles [BK][BQ]; lse, delta [BQ]
  return sizeof(float) *
         (2 * kBlockK * D + 2 * kBlockQ * (D + 1) + 2 * kBlockK * kBlockQ + 2 * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int tq, int tk, int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][D]
  float* dos = qs + kBlockQ * D;          // [BQ][D]
  float* ks = dos + kBlockQ * D;          // [BK][D+1]
  float* vs = ks + kBlockK * (D + 1);     // [BK][D+1]
  float* dss = vs + kBlockK * (D + 1);    // [BQ][BK]
  float* lses = dss + kBlockQ * kBlockK;  // [BQ]
  float* deltas = lses + kBlockQ;         // [BQ]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the q tile
  const size_t qoff = ((size_t)bh * tq + q0) * D;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const bool in = q0 + i / D < tq;
    qs[i] = in ? q[qoff + i] : 0.f;
    dos[i] = in ? dout[qoff + i] : 0.f;
  }
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const bool in = q0 + i < tq;
    lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
    deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
  }

  constexpr int kCols = D / 32;  // dq columns per lane
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  // Causal: key tiles that start past this q tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is stored)
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < tk;
      ks[r * (D + 1) + c] = in ? kb[(size_t)k0 * D + i] : 0.f;
      vs[r * (D + 1) + c] = in ? vb[(size_t)k0 * D + i] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = do v^T for this warp's rows; the lane owns key
    // columns lane and lane + 32.
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float k_lo = ks[lane * (D + 1) + c];
      const float k_hi = ks[(lane + 32) * (D + 1) + c];
      const float v_lo = vs[lane * (D + 1) + c];
      const float v_hi = vs[(lane + 32) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qs[(row0 + r) * D + c];
        const float dov = dos[(row0 + r) * D + c];
        s[r][0] = fmaf(qv, k_lo, s[r][0]);
        s[r][1] = fmaf(qv, k_hi, s[r][1]);
        dp[r][0] = fmaf(dov, v_lo, dp[r][0]);
        dp[r][1] = fmaf(dov, v_hi, dp[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
      const float row_lse = lses[row0 + r];
      const float row_delta = deltas[row0 + r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        const bool keep = col < tk && (!causal || row >= col);
        const float p = prob(s[r][j], row_lse, keep, sm_scale);
        dss[(row0 + r) * kBlockK + lane + 32 * j] = p * (dp[r][j] - row_delta) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the ds rows it wrote

    // dq += ds k; the lane owns dq columns lane + 32 c.
    for (int j = 0; j < kBlockK; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[j * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsv = dss[(row0 + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsv, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (q0 + row0 + r >= tq) continue;
    float* dqrow = dq + qoff + (size_t)(row0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqrow[lane + 32 * c] = acc[r][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int causal,
                     float sm_scale) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [BK][D]
  float* vs = ks + kBlockK * D;           // [BK][D]
  float* qs = vs + kBlockK * D;           // [BQ][D+1]
  float* dos = qs + kBlockQ * (D + 1);    // [BQ][D+1]
  float* ps = dos + kBlockQ * (D + 1);    // [BK][BQ]
  float* dss = ps + kBlockK * kBlockQ;    // [BK][BQ]
  float* lses = dss + kBlockK * kBlockQ;  // [BQ]
  float* deltas = lses + kBlockQ;         // [BQ]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the k tile
  const size_t koff = ((size_t)bh * tk + k0) * D;
  const float* qb = q + (size_t)bh * tq * D;
  const float* dob = dout + (size_t)bh * tq * D;

  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const bool in = k0 + i / D < tk;
    ks[i] = in ? k[koff + i] : 0.f;
    vs[i] = in ? v[koff + i] : 0.f;
  }

  constexpr int kCols = D / 32;  // dk / dv columns per lane
  float acc_dk[kRowsPerWarp][kCols], acc_dv[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  // Causal: q tiles that end before this k tile's first row are all masked;
  // with kBlockQ == kBlockK the first q tile to visit is the one at k0.
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile is consumed (and the k/v tile is stored)
    for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < tq;
      qs[r * (D + 1) + c] = in ? qb[(size_t)q0 * D + i] : 0.f;
      dos[r * (D + 1) + c] = in ? dob[(size_t)q0 * D + i] : 0.f;
    }
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool in = q0 + i < tq;
      lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
      deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's k rows; the lane owns q
    // columns lane and lane + 32.
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float q_lo = qs[lane * (D + 1) + c];
      const float q_hi = qs[(lane + 32) * (D + 1) + c];
      const float do_lo = dos[lane * (D + 1) + c];
      const float do_hi = dos[(lane + 32) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float kv = ks[(row0 + r) * D + c];
        const float vv = vs[(row0 + r) * D + c];
        s[r][0] = fmaf(q_lo, kv, s[r][0]);
        s[r][1] = fmaf(q_hi, kv, s[r][1]);
        dp[r][0] = fmaf(do_lo, vv, dp[r][0]);
        dp[r][1] = fmaf(do_hi, vv, dp[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int col = k0 + row0 + r;  // the key index
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qj = lane + 32 * j;
        const int row = q0 + qj;  // the query index
        const bool keep = col < tk && row < tq && (!causal || row >= col);
        const float p = prob(s[r][j], lses[qj], keep, sm_scale);
        ps[(row0 + r) * kBlockQ + qj] = p;
        dss[(row0 + r) * kBlockQ + qj] = p * (dp[r][j] - deltas[qj]) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the p / ds rows it wrote

    // dv += p^T do and dk += ds^T q; the lane owns columns lane + 32 c.
    for (int j = 0; j < kBlockQ; ++j) {
      float dov[kCols], qv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dos[j * (D + 1) + lane + 32 * c];
        qv[c] = qs[j * (D + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pv = ps[(row0 + r) * kBlockQ + j];
        const float dsv = dss[(row0 + r) * kBlockQ + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[r][c] = fmaf(pv, dov[c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(dsv, qv[c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (k0 + row0 + r >= tk) continue;
    float* dkrow = dk + koff + (size_t)(row0 + r) * D;
    float* dvrow = dv + koff + (size_t)(row0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkrow[lane + 32 * c] = acc_dk[r][c];
      dvrow[lane + 32 * c] = acc_dv[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernels: the dk/dv pass, then the dq pass with its own
// tile constants.

using bf16 = __nv_bfloat16;

constexpr int kTcBlockK = 64;  // key rows per block, 16 per warp
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
// q rows per tile: 64 at d = 64; 32 at d = 128, where the dK and dV
// accumulators take 128 registers a lane.
template <int D>
constexpr int kTcBlockQ = D == 64 ? 64 : 32;

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  // k, v tiles [BK][D+8]; q, do rings [2][BQ][D+8]; lse, delta rings [2][BQ] f32;
  // per warp, 32 re-summed pairs: results (float2) and (query, key) items
  return sizeof(bf16) * (2 * kTcBlockK + 4 * kTcBlockQ<D>) * (D + 8) +
         sizeof(float) * 4 * kTcBlockQ<D> + kTcWarps * 32 * (sizeof(float2) + sizeof(uint32_t));
}

// Rounding p and ds to bf16 as the plain version does.  The mma sums of s
// and dp add the same exact bf16 products as the plain version's float32
// sums, in another order, so the two differ by a few float32 ulps of the
// partial sums; a p or ds that lies that close to a bf16 rounding boundary
// could round the other way, and a flipped ds near 0.5 moves dk by 2^-9 |q|
// (dq by 2^-9 |k|).  Such pairs are summed again in the plain version's
// order, float32 FMAs over d from 0, which gives its p and ds bit for bit.
// The screen bounds the two sums' difference by kSumErr (|x| + 16) for a
// sum x of s or dp, 3e-5 or more: several times what the two orders differ
// by on sums of 64 to 128 unit-scale products.  Values below kTieFloor are
// not screened: a flip there moves dq, dk or dv by at most 2^-15 |k|, |q|
// or |do|.  Each screened pair costs a 64- to 128-step FMA chain, so the
// floor sets the kernels' price: in the dk/dv pass at 2^-9 about one warp
// tile in 1.5 has a pair to sum again, at 2^-7 one in 6.
constexpr float kSumErr = 0x1p-19f;
constexpr float kTieFloor = 0x1p-7f;

// Distance from x to the midpoint between the two bf16 values around it
// (the rounding boundary; exact, both lie in one binade).
__device__ __forceinline__ float tie_gap(float x) {
  return fabsf(x - __uint_as_float((__float_as_uint(x) & 0xffff0000u) | 0x8000u));
}

// kSumErr (|x| + 16) scale for a sum x of s or dp, as one FMA (tie_scale =
// kSumErr scale): for s the relative change of p, for dp the change of
// dp scale, that the order of the sums can make.
__device__ __forceinline__ float sum_err(float x, float tie_scale) {
  return fmaf(fabsf(x), tie_scale, 16.f * tie_scale);
}

// Whether ds = p (dp - delta) scale could round to another bf16 value than
// in the plain version, with es = sum_err(s), edp = sum_err(dp).  Bitwise,
// not short-circuit: no branch per pair.
__device__ __forceinline__ bool near_ds(float ds, float p, float es, float edp) {
  return (fabsf(ds) >= kTieFloor) & (tie_gap(ds) <= fabsf(ds) * es + p * edp);
}

// p and ds of one (query, key) pair in the plain version's order: s and dp
// as float32 FMAs over d from 0 (the FMA kernels' order, and that of the
// plain version's float32 GEMMs), s * scale rounded before lse is taken off.
// The pair was screened with p > 0, so it is visible and lse is finite.
// acc + a . b over the 8 bf16 pairs of a and b (16 bytes each), one FMA
// each, in order (the lower half of a word is the earlier element).
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    acc = fmaf(__uint_as_float(aw[w] << 16), __uint_as_float(bw[w] << 16), acc);
    acc = fmaf(__uint_as_float(aw[w] & 0xffff0000u), __uint_as_float(bw[w] & 0xffff0000u), acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ float2 pair_in_plain_order(const bf16* qrow, const bf16* krow,
                                                      const bf16* dorow, const bf16* vrow,
                                                      float lse, float delta, float sm_scale) {
  float s = 0.f, dp = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 8) {
    s = dot8(*reinterpret_cast<const uint4*>(qrow + c), *reinterpret_cast<const uint4*>(krow + c), s);
    dp = dot8(*reinterpret_cast<const uint4*>(dorow + c), *reinterpret_cast<const uint4*>(vrow + c),
              dp);
  }
  const float p = expf(__fmul_rn(s, sm_scale) - lse);
  return make_float2(p, p * (dp - delta) * sm_scale);
}

// Replace the screened pairs by their plain-order values.  Bit i of `near`
// flags element i (of N) of this lane's score fragments; pair(i) gives that
// element's query, a row of the q and do tiles qst, dost and an index of
// lst, dlt, and its key, a row of the k and v tiles kst, vst, as
// query | key << 8; set(i, hit, v) puts v = (p, ds) in place of element i
// where hit.  The warp lists its pairs in shared memory and each lane sums
// one, 32 a round.
template <int D, int N, typename Pair, typename Set>
__device__ __forceinline__ void resum_near_ties(uint32_t near, Pair pair, Set set,
                                                const bf16* qst, const bf16* dost,
                                                const bf16* kst, const bf16* vst,
                                                const float* lst, const float* dlt,
                                                uint32_t* items, float2* vals, int lane,
                                                float sm_scale) {
  static_assert(N <= 32, "one bit of `near` per element");
  constexpr int kS = D + 8;
  const int n = __popc(near);
  int incl = n;  // inclusive prefix sum over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  // Pair i of this lane takes slot first + (its rank among the lane's
  // pairs) - r0 in round r0.  Both loops below are free of per-pair
  // branches: lanes differ in which pairs they hold.
  for (int r0 = 0; r0 < total; r0 += 32) {
    const int first = incl - n - r0;
    for (uint32_t m = near; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      const int slot = first + __popc(near & ((1u << i) - 1));
      if (static_cast<unsigned>(slot) < 32) items[slot] = pair(i);
    }
    __syncwarp();
    if (lane < total - r0) {
      const int qi = items[lane] & 0xff, kr = items[lane] >> 8;
      vals[lane] = pair_in_plain_order<D>(qst + qi * kS, kst + kr * kS, dost + qi * kS,
                                          vst + kr * kS, lst[qi], dlt[qi], sm_scale);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int slot = first + __popc(near & ((1u << i) - 1));
      set(i, (near >> i & 1) & (static_cast<unsigned>(slot) < 32), vals[slot & 31]);
    }
    __syncwarp();  // the next round rewrites items and vals
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
                          int causal, float sm_scale) {
  using namespace mma_bf16;
  constexpr int kS = D + 8;  // shared row stride, elements
  constexpr int BQ = kTcBlockQ<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                // [BK][kS]
  bf16* vs = ks + kTcBlockK * kS;                              // [BK][kS]
  bf16* qs = vs + kTcBlockK * kS;                              // [2][BQ][kS]
  bf16* dos = qs + 2 * BQ * kS;                                // [2][BQ][kS]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * kS);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                               // [2][BQ]
  float2* vals = reinterpret_cast<float2*>(deltas + 2 * BQ);   // [warps][32]
  uint32_t* items = reinterpret_cast<uint32_t*>(vals + kTcWarps * 32);  // [warps][32]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcBlockK;  // low k tiles walk the most q tiles and start first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;  // this lane's key rows: key_lo, key_lo + 8
  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* dob = dout + (size_t)bh * tq * D;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;

  // q, do, lse and delta rows [q0, q0 + BQ) into stage st; rows past tq
  // arrive as zeros and are masked out of p below.
  auto load_q_tile = [&](int q0, int st) {
    load_rows<BQ, D, kTcThreads>(qs + st * BQ * kS, qb, q0, tq);
    load_rows<BQ, D, kTcThreads>(dos + st * BQ * kS, dob, q0, tq);
    if (threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x % BQ;
      const bool in = q0 + i < tq;
      const float* src = threadIdx.x < BQ ? lb : db;
      float* dst = (threadIdx.x < BQ ? lses : deltas) + st * BQ + i;
      cp_async4(dst, in ? src + q0 + i : src, in ? 4 : 0);
    }
  };

  // Causal: q tiles that end before this k tile's first row are all masked.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + BQ - 1) / BQ : 0;

  const float tie_scale = kSumErr * sm_scale;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];  // 8 columns per block
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  if (n_tiles > 0) {
    load_rows<kTcBlockK, D, kTcThreads>(ks, k + (size_t)bh * tk * D, k0, tk);
    load_rows<kTcBlockK, D, kTcThreads>(vs, v + (size_t)bh * tk * D, k0, tk);
    load_q_tile(q_begin, 0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    const int st = it & 1;
    if (it + 1 < n_tiles) load_q_tile(q0 + BQ, st ^ 1);  // released by the last barrier
    cp_async_commit();  // possibly empty, so that one group always stays in flight
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qst = qs + st * BQ * kS;
    const bf16* dost = dos + st * BQ * kS;
    const float* lst = lses + st * BQ;
    const float* dlt = deltas + st * BQ;

    // s^T = k q^T and dp^T = v do^T: 16 keys x BQ queries a warp.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, a_frag(ks, kS, warp * 16, kk * 16, lane));
      ldmatrix_x4(va, a_frag(vs, kS, warp * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair(qst, kS, j * 16, kk * 16, lane));
        mma(s[2 * j], ka, b[0], b[1]);
        mma(s[2 * j + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, b_pair(dost, kS, j * 16, kk * 16, lane));
        mma(dp[2 * j], va, b[0], b[1]);
        mma(dp[2 * j + 1], va, b[2], b[3]);
      }
    }

    // p^T and ds^T = p^T (dp^T - delta) scale, in place of s^T and dp^T;
    // the mask only where the tiles cross the diagonal or a ragged end.
    const bool masked = q0 + BQ > tq || k0 + kTcBlockK > tk ||
                        (causal && q0 < k0 + kTcBlockK - 1);
    uint32_t near = 0;  // pairs whose bf16 rounding the order of the sums could flip
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);  // the query, in the tile
        const int row = q0 + qi;
        const int key = key_lo + (e >> 1) * 8;
        const bool keep = !masked || (key < tk && row < tq && (!causal || row >= key));
        const float p = prob(s[j][e], lst[qi], keep, sm_scale);
        const float ds = p * (dp[j][e] - dlt[qi]) * sm_scale;
        const float es = sum_err(s[j][e], tie_scale);
        // bitwise, not short-circuit: no branch per pair
        const bool near_p = (p >= kTieFloor) & (tie_gap(p) <= p * es);
        near |= static_cast<uint32_t>(near_p | near_ds(ds, p, es, sum_err(dp[j][e], tie_scale)))
                << (j * 4 + e);
        dp[j][e] = ds;
        s[j][e] = p;
      }
    // Element i = j * 4 + e of s and dp: query (i / 4) * 8 + 2t + (i & 1) of
    // the tile, key row g + (i & 2) * 4 of the warp's 16.
    if (__any_sync(0xffffffffu, near))
      resum_near_ties<D, BQ / 2>(
          near,
          [&](int i) { return ((i / 4) * 8 + 2 * t + (i & 1)) | (g + (i & 2) * 4) << 8; },
          [&](int i, bool hit, float2 x) {
            s[i / 4][i % 4] = hit ? x.x : s[i / 4][i % 4];
            dp[i / 4][i % 4] = hit ? x.y : dp[i / 4][i % 4];
          },
          qst, dost, ks + warp * 16 * kS, vs + warp * 16 * kS, lst, dlt, items + warp * 32,
          vals + warp * 32, lane, sm_scale);

    // dv += p^T do and dk += ds^T q: p^T and ds^T rounded to bf16 in the A
    // fragments, do and q through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
      a_from_acc(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_pair(dost, kS, kk * 16, j * 16, lane));
        mma(acc_dv[2 * j], pa, b[0], b[1]);
        mma(acc_dv[2 * j + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, bt_pair(qst, kS, kk * 16, j * 16, lane));
        mma(acc_dk[2 * j], da, b[0], b[1]);
        mma(acc_dk[2 * j + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed: the next iteration's prefetch may refill it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key >= tk) continue;
    float* dkrow = dk + ((size_t)bh * tk + key) * D + 2 * t;
    float* dvrow = dv + ((size_t)bh * tk + key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dkrow + j * 8) = make_float2(acc_dk[j][2 * h], acc_dk[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dvrow + j * 8) = make_float2(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
    }
  }
}

// dq pass.
constexpr int kDqBlockK = 64;  // key rows per tile

// 16-row m tiles a warp owns: two at d = 64, so that each K and V fragment
// read from shared memory feeds two products; one at d = 128, where dq alone
// takes 64 registers a lane per m tile.
template <int D>
constexpr int kDqMTiles = D == 64 ? 2 : 1;
template <int D>
constexpr int kDqBlockQ = kTcWarps * 16 * kDqMTiles<D>;  // query rows per block
// Keys per score chunk: s and dp of a chunk take 32 registers a lane each,
// one bit of the screen's mask per score.
template <int D>
constexpr int kDqChunk = 64 / kDqMTiles<D>;

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  // q, do tiles [BQ][D+8]; K and V rings [2][BK][D+8]; per warp, 32
  // re-summed pairs: results (float2) and (query, key) items; lse, delta [BQ] f32
  return sizeof(bf16) * (2 * kDqBlockQ<D> + 4 * kDqBlockK) * (D + 8) +
         kTcWarps * 32 * (sizeof(float2) + sizeof(uint32_t)) + sizeof(float) * 2 * kDqBlockQ<D>;
}

// Two blocks an SM, as the forward kernel: the q and dq fragments stay in
// registers for the whole key loop.  The do fragments are read again from
// shared memory for each chunk: kept in registers too (`tools/tie_variants.py
// dq:do_regs`), they made it no faster.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int tq, int tk, int causal, float sm_scale) {
  using namespace mma_bf16;
  constexpr int kS = D + 8;  // shared row stride, elements
  constexpr int MT = kDqMTiles<D>;
  constexpr int BQ = kDqBlockQ<D>;
  constexpr int BK = kDqBlockK;
  constexpr int KC = kDqChunk<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                // [BQ][kS]
  bf16* dos = qs + BQ * kS;                                    // [BQ][kS]
  bf16* ks = dos + BQ * kS;                                    // [2][BK][kS]
  bf16* vs = ks + 2 * BK * kS;                                 // [2][BK][kS]
  float2* vals = reinterpret_cast<float2*>(vs + 2 * BK * kS);  // [warps][32]
  uint32_t* items = reinterpret_cast<uint32_t*>(vals + kTcWarps * 32);  // [warps][32]
  float* lses = reinterpret_cast<float*>(items + kTcWarps * 32);  // [BQ], for the re-summing
  float* deltas = lses + BQ;                                      // [BQ]

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;  // longest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16 * MT;  // this warp's first row in the tile
  // This lane's rows: q0 + wrow + 16 mt + g + 8 h, for m tile mt and half h.
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;
  const float* lb = lse + (size_t)bh * tq + q0;  // lse and delta of the tile's rows
  const float* db = delta + (size_t)bh * tq + q0;

  // Causal: key tiles that start past this q tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;  // 0 only when tk == 0

  // lse and delta of this lane's rows; a row past tq sees no key (p = 0).
  float lse_r[MT][2], delta_r[MT][2];
  float acc[MT][D / 8][4];      // dq, 8 columns per block
  uint32_t qf[MT][D / 16][4];  // the warp's q rows as A fragments
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + 16 * mt + g + 8 * h;
      const bool in = q0 + r < tq;
      lse_r[mt][h] = in ? lb[r] : -CUDART_INF_F;
      delta_r[mt][h] = in ? db[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  if (n_tiles > 0) {
    load_rows<BQ, D, kTcThreads>(qs, q + (size_t)bh * tq * D, q0, tq);
    load_rows<BQ, D, kTcThreads>(dos, dout + (size_t)bh * tq * D, q0, tq);
    load_rows<BK, D, kTcThreads>(ks, kb, 0, tk);
    load_rows<BK, D, kTcThreads>(vs, vb, 0, tk);
    for (int i = threadIdx.x; i < 2 * BQ; i += kTcThreads) {
      const int r = i % BQ;
      const bool in = q0 + r < tq;
      const float* src = i < BQ ? lb : db;
      cp_async4((i < BQ ? lses : deltas) + r, in ? src + r : src, in ? 4 : 0);
    }
    cp_async_commit();
  }
  const float tie_scale = kSumErr * sm_scale;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the stage read in iteration it - 1, released by its last barrier
      load_rows<BK, D, kTcThreads>(ks + (st ^ 1) * BK * kS, kb, k0 + BK, tk);
      load_rows<BK, D, kTcThreads>(vs + (st ^ 1) * BK * kS, vb, k0 + BK, tk);
    }
    cp_async_commit();  // possibly empty, so that one group always stays in flight
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[mt][kk], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
    }
    const bf16* kst = ks + st * BK * kS;
    const bf16* vst = vs + st * BK * kS;

    // Not unrolled: with two copies of the body, and so of the re-summing
    // code, which runs rarely, the kernel is much slower
    // (`tools/tie_variants.py dq:unrolled`).
#pragma unroll 1
    for (int kc = 0; kc < BK; kc += KC) {
      // s = q k^T and dp = do v^T over keys kc.. of the tile: 16 MT rows x
      // KC keys a warp, 8 keys per block.
      float s[MT][KC / 8][4], dp[MT][KC / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = dp[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t dof[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(dof[mt], a_frag(dos, kS, wrow + 16 * mt, kk * 16, lane));
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, b_pair(kst, kS, kc + j * 16, kk * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][2 * j], qf[mt][kk], b[0], b[1]);
            mma(s[mt][2 * j + 1], qf[mt][kk], b[2], b[3]);
          }
          ldmatrix_x4(b, b_pair(vst, kS, kc + j * 16, kk * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(dp[mt][2 * j], dof[mt], b[0], b[1]);
            mma(dp[mt][2 * j + 1], dof[mt], b[2], b[3]);
          }
        }
      }

      // ds = p (dp - delta) scale in place of dp; the mask only where the
      // chunk crosses the diagonal or the ragged end.
      const int c0 = k0 + kc;  // the chunk's first key
      const bool masked = c0 + KC > tk || (causal && c0 + KC - 1 > q0);
      uint32_t near = 0;  // pairs whose bf16 rounding of ds the order of the sums could flip
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + wrow + 16 * mt + g + (e >> 1) * 8;
            const int key = c0 + j * 8 + 2 * t + (e & 1);
            const bool keep = !masked || (key < tk && (!causal || row >= key));
            const float p = prob(s[mt][j][e], lse_r[mt][e >> 1], keep, sm_scale);
            const float ds = p * (dp[mt][j][e] - delta_r[mt][e >> 1]) * sm_scale;
            near |= static_cast<uint32_t>(near_ds(ds, p, sum_err(s[mt][j][e], tie_scale),
                                                  sum_err(dp[mt][j][e], tie_scale)))
                    << ((mt * (KC / 8) + j) * 4 + e);
            dp[mt][j][e] = ds;
          }
      // Element i = (mt * KC / 8 + j) * 4 + e of dp: query row
      // wrow + 16 mt + g + (i & 2) * 4 of the tile, key kc + 8 j + 2t + (i & 1).
      if (__any_sync(0xffffffffu, near))
        resum_near_ties<D, MT * KC / 2>(
            near,
            [&](int i) {
              return (wrow + 16 * (i / (KC / 2)) + g + (i & 2) * 4) |
                     (kc + (i / 4) % (KC / 8) * 8 + 2 * t + (i & 1)) << 8;
            },
            [&](int i, bool hit, float2 x) {
              float& d = dp[i / (KC / 2)][(i / 4) % (KC / 8)][i % 4];
              d = hit ? x.y : d;
            },
            qs, dos, kst, vst, lses, deltas, items + warp * 32, vals + warp * 32, lane, sm_scale);

      // dq += ds k: ds rounded to bf16 (k's dtype) in the A fragments, K
      // through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) a_from_acc(a[mt], dp[mt][2 * kk], dp[mt][2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt_pair(kst, kS, kc + kk * 16, j * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][2 * j], a[mt], b[0], b[1]);
            mma(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next iteration's prefetch may refill it
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wrow + 16 * mt + g + 8 * h;
      if (row >= tq) continue;
      float* dqrow = dq + ((size_t)bh * tq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dqrow + j * 8) = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    }
}

// One launch of a kernel of either pass: its dynamic shared memory raised to
// smem, the inputs cast to T, then the outputs.
template <typename T, typename Kernel, typename... Out>
cudaError_t launch(Kernel kernel, size_t smem, int threads, dim3 grid, const void* q,
                   const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int tq, int tk, int causal, float sm_scale,
                   cudaStream_t stream, Out*... out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, out..., tq, tk, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, int bh, int tq, int tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_bwd_dq_kernel<D>, dq_smem_bytes<D>(), kThreads,
                         dim3(bh, (tq + kBlockQ - 1) / kBlockQ), q, k, v, dout, lse, delta, tq,
                         tk, causal, sm_scale, stream, dq);
  return launch<bf16>(flash_bwd_dq_bf16_kernel<D>, dq_bf16_smem_bytes<D>(), kTcThreads,
                      dim3(bh, (tq + kDqBlockQ<D> - 1) / kDqBlockQ<D>), q, k, v, dout, lse,
                      delta, tq, tk, causal, sm_scale, stream, dq);
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int tq, int tk, int causal, float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_bwd_dkv_kernel<D>, dkv_smem_bytes<D>(), kThreads,
                         dim3(bh, (tk + kBlockK - 1) / kBlockK), q, k, v, dout, lse, delta, tq,
                         tk, causal, sm_scale, stream, dk, dv);
  return launch<bf16>(flash_bwd_dkv_bf16_kernel<D>, dkv_bf16_smem_bytes<D>(), kTcThreads,
                      dim3(bh, (tk + kTcBlockK - 1) / kTcBlockK), q, k, v, dout, lse, delta,
                      tq, tk, causal, sm_scale, stream, dk, dv);
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 = float32 (the FMA
// kernels), 1 = bfloat16 (the tensor-core kernels).  The caller has checked
// shapes, types, contiguity and 16-byte alignment, launches the dq pass
// only when bh > 0 and tq > 0 and the dk/dv pass only when bh > 0 and
// tk > 0.  Each returns its launch's CUDA error code (0 = none).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, int causal, float sm_scale,
                            void* stream) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  const auto run = d == 64 ? launch_dq<64> : launch_dq<128>;
  return run(dtype, q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<float*>(dq), bh, tq, tk, causal,
             sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  const auto run = d == 64 ? launch_dkv<64> : launch_dkv<128>;
  return run(dtype, q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
             bh, tq, tk, causal, sm_scale, static_cast<cudaStream_t>(stream));
}
