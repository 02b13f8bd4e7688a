// Flash attention backward for one block: Hopper (sm_90a).
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// polyaxon_tpu/parallel/flash.py (called there through `flash_block_bwd`).
// Same function, from q, do [BH, Tq, d], k, v [BH, Tk, d] (bf16 or f32,
// contiguous, d a multiple of 8 from 8 to 256) and the forward's lse and
// delta = rowsum(do o) [BH, Tq] (f32):
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
// the products close behind.  At head_dim 96 (BH = 20 x 32): dq 760.2 MB or
// 226.9 us, dk/dv 1011.9 MB or 302.1 us; at 256 (BH = 20 x 8): 504.6 MB or
// 150.6 us, 672.4 MB or 200.7 us; bytes at both.
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
// (tensor cores would need TF32 there, a different result).  Each kernel is
// compiled for tile widths W of 32, 64, 96, 128 and 256 and runs at the
// least W >= d (`head_dims.cuh`); the tiles' columns d..W are zero in shared
// memory and never stored.
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
//     at W <= 64 (two m16 tiles a warp, so that each K and V fragment read
//     from shared memory feeds two products) and 64 from W = 96 on (one).
//     The q and do tiles are staged once; the q rows stay in registers as A
//     fragments up to W = 128 (at W = 256, where dq alone takes 128
//     registers a lane, they are read again from shared memory as the do
//     rows are), the do rows are read again for each chunk of keys.  K and
//     V tiles arrive through cp.async in a two-stage ring, tile j + 1 in
//     flight while tile j is used.  S = Q K^T and dP = dO V^T are
//     mma.sync m16n8k16 bf16 products with q rows as mma rows (K and V as B
//     fragments through ldmatrix), taken over chunks of 32 keys at W <= 64
//     and at W = 256 and of 64 at W = 96 and 128, so that s and dp of a
//     chunk are 32 registers a lane each (16 at W = 256).  ds = p (dp - delta) scale is screened (ds only: the pass
//     rounds nothing else) and converted in registers into the bf16 A
//     fragment of dQ += dS K, K through ldmatrix.trans: that conversion is
//     the TPU kernel's ds.astype(k.dtype), and ds never goes through shared
//     memory.  Each lane reads lse and delta of its rows once.  Causal q
//     tiles are scheduled longest first.  What holds it back: the screen
//     and the rounds of re-summing (about a quarter of its time), mma.sync at
//     about two thirds of the wgmma rate, and the 128-row q tiles at
//     W <= 64, which span two key tiles on the diagonal, where part of each
//     warp's scores are masked.
//   float32, `flash_bwd_dq_kernel`: each of the 8 warps owns 8 rows of a
//     64-row q tile (4 of a 32-row tile at W = 256, where 64-row tiles would
//     not fit in shared memory); a lane holds two columns of the 64 x 64
//     score tile for each (one of 32 x 32), writes its ds values to a shared
//     tile, and then owns W / 32 dq columns of each of its rows.  Tiles are staged in shared memory,
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
//     are 64 rows at W <= 64 and 32 from W = 96 on, so the dK and dV
//     accumulators (W registers a lane together) sit beside the score
//     tiles without spills; at W = 256 they would take all 256 registers,
//     so a third grid axis splits the dK and dV columns in two halves of
//     128: each block computes the whole s^T and dp^T and accumulates its
//     half (the score products are done twice, the accumulators halved; one
//     pass for dk and one for dv would save dp^T in the dv pass but needs a
//     second kernel).  K and V fragments are re-read from shared memory for
//     each q tile.  With k tiles of 64 rows the first q tile a
//     causal block visits is (k0 / BQ) * BQ.  What holds it back now: the
//     screen and the serial FMA chains of the re-summed pairs (a warp's
//     round stalls its block at the tile's barrier), mma.sync at about two
//     thirds of the wgmma rate, and the dk/dv pass and the dq pass each
//     read q, k, v and do (a fused single pass would read them once).
//   float32, `flash_bwd_dkv_kernel`: the dq pass's FMA design transposed
//     (a lane holds two q columns of each of its warp's 8 key rows; 32-row
//     tiles at W = 256 again), for the small float32 correctness runs.
// The ragged tail (T not a multiple of the tile) is masked in the kernels:
// out-of-range rows load as zeros and are masked out of p (lse = -inf for
// query rows past the end), so they add nothing, and are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_dims.cuh"
#include "mma_bf16.cuh"

namespace {

// The float32 FMA kernels.  With float32 inputs the TPU kernel's roundings
// (ds to k's and q's dtype, p to do's) change nothing.  Tiles are W columns
// wide; the tensors' rows are d long (d <= W), the columns past d zero in
// shared memory.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// q rows and k rows per tile, one number: the causal loop bounds rely on
// the two being equal.  64, and 32 at W = 256, where 64-row tiles would
// take 273 KB (dq) and 289 KB (dk/dv) of shared memory, past the 227 KB a
// block may have.
template <int W>
constexpr int kF32Tile = W == 256 ? 32 : 64;

// p = exp(s * scale - lse) where kept; 0 where masked or where the row saw
// no key (lse = -inf, where exp would overflow).
__device__ __forceinline__ float prob(float s, float lse, bool keep, float scale) {
  return (keep && lse != -CUDART_INF_F) ? expf(s * scale - lse) : 0.f;
}

template <int W>
constexpr size_t dq_smem_bytes() {
  // q, do tiles [B][W]; k, v tiles [B][W+1]; ds tile [B][B]; lse, delta [B]
  constexpr int B = kF32Tile<W>;
  return sizeof(float) * (2 * B * W + 2 * B * (W + 1) + B * B + 2 * B);
}

template <int W>
constexpr size_t dkv_smem_bytes() {
  // k, v tiles [B][W]; q, do tiles [B][W+1]; p, ds tiles [B][B]; lse, delta [B]
  constexpr int B = kF32Tile<W>;
  return sizeof(float) * (2 * B * W + 2 * B * (W + 1) + 2 * B * B + 2 * B);
}

// Rows [r0, r0 + B) of a [t, d] float32 matrix into a shared tile of row
// stride `stride` (W, or W + 1 where a lane reads one row each); rows past t
// and columns past d arrive as zeros.
template <int B, int W>
__device__ __forceinline__ void load_f32_rows(float* s, int stride, const float* g, int r0,
                                              int t, int d) {
  for (int i = threadIdx.x; i < B * W; i += kThreads) {
    const int r = i / W, c = i % W;
    s[r * stride + c] = (r0 + r < t && c < d) ? g[(size_t)(r0 + r) * d + c] : 0.f;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int tq, int tk, int d, int causal, float sm_scale) {
  constexpr int B = kF32Tile<W>;      // q rows and k rows per tile
  constexpr int RW = B / kWarps;      // rows a warp owns
  constexpr int KL = B / 32;          // key columns a lane owns
  extern __shared__ float smem[];
  float* qs = smem;                   // [B][W]
  float* dos = qs + B * W;            // [B][W]
  float* ks = dos + B * W;            // [B][W+1]
  float* vs = ks + B * (W + 1);       // [B][W+1]
  float* dss = vs + B * (W + 1);      // [B][B]
  float* lses = dss + B * B;          // [B]
  float* deltas = lses + B;           // [B]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;  // this warp's first row in the q tile
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  load_f32_rows<B, W>(qs, W, q + (size_t)bh * tq * d, q0, tq, d);
  load_f32_rows<B, W>(dos, W, dout + (size_t)bh * tq * d, q0, tq, d);
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const bool in = q0 + i < tq;
    lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
    deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
  }

  constexpr int kCols = W / 32;  // dq columns per lane
  float acc[RW][kCols];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  // Causal: key tiles that start past this q tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + B) : tk;
  for (int k0 = 0; k0 < k_end; k0 += B) {
    __syncthreads();  // the previous tile is consumed (and the q tile is stored)
    load_f32_rows<B, W>(ks, W + 1, kb, k0, tk, d);
    load_f32_rows<B, W>(vs, W + 1, vb, k0, tk, d);
    __syncthreads();

    // s = q k^T and dp = do v^T for this warp's rows; the lane owns key
    // columns lane + 32 j.
    float s[RW][KL], dp[RW][KL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < KL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int c = 0; c < d; ++c) {  // the zero columns past d add nothing
      float kc[KL], vc[KL];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        kc[j] = ks[(lane + 32 * j) * (W + 1) + c];
        vc[j] = vs[(lane + 32 * j) * (W + 1) + c];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float qv = qs[(row0 + r) * W + c];
        const float dov = dos[(row0 + r) * W + c];
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          s[r][j] = fmaf(qv, kc[j], s[r][j]);
          dp[r][j] = fmaf(dov, vc[j], dp[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = q0 + row0 + r;
      const float row_lse = lses[row0 + r];
      const float row_delta = deltas[row0 + r];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const int col = k0 + lane + 32 * j;
        const bool keep = col < tk && (!causal || row >= col);
        const float p = prob(s[r][j], row_lse, keep, sm_scale);
        dss[(row0 + r) * B + lane + 32 * j] = p * (dp[r][j] - row_delta) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the ds rows it wrote

    // dq += ds k; the lane owns dq columns lane + 32 c.
    for (int j = 0; j < B; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[j * (W + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float dsv = dss[(row0 + r) * B + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsv, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (q0 + row0 + r >= tq) continue;
    float* dqrow = dq + ((size_t)bh * tq + q0 + row0 + r) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < d) dqrow[lane + 32 * c] = acc[r][c];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d,
                     int causal, float sm_scale) {
  constexpr int B = kF32Tile<W>;      // k rows and q rows per tile
  constexpr int RW = B / kWarps;      // rows a warp owns
  constexpr int QL = B / 32;          // query columns a lane owns
  extern __shared__ float smem[];
  float* ks = smem;                   // [B][W]
  float* vs = ks + B * W;             // [B][W]
  float* qs = vs + B * W;             // [B][W+1]
  float* dos = qs + B * (W + 1);      // [B][W+1]
  float* ps = dos + B * (W + 1);      // [B][B]
  float* dss = ps + B * B;            // [B][B]
  float* lses = dss + B * B;          // [B]
  float* deltas = lses + B;           // [B]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;  // this warp's first row in the k tile
  const float* qb = q + (size_t)bh * tq * d;
  const float* dob = dout + (size_t)bh * tq * d;

  load_f32_rows<B, W>(ks, W, k + (size_t)bh * tk * d, k0, tk, d);
  load_f32_rows<B, W>(vs, W, v + (size_t)bh * tk * d, k0, tk, d);

  constexpr int kCols = W / 32;  // dk / dv columns per lane
  float acc_dk[RW][kCols], acc_dv[RW][kCols];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  // Causal: q tiles that end before this k tile's first row are all masked;
  // with q and k tiles of one size the first q tile to visit is the one at k0.
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < tq; q0 += B) {
    __syncthreads();  // the previous tile is consumed (and the k/v tile is stored)
    load_f32_rows<B, W>(qs, W + 1, qb, q0, tq, d);
    load_f32_rows<B, W>(dos, W + 1, dob, q0, tq, d);
    for (int i = threadIdx.x; i < B; i += kThreads) {
      const bool in = q0 + i < tq;
      lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
      deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's k rows; the lane owns q
    // columns lane + 32 j.
    float s[RW][QL], dp[RW][QL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < QL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int c = 0; c < d; ++c) {  // the zero columns past d add nothing
      float qc[QL], doc[QL];
#pragma unroll
      for (int j = 0; j < QL; ++j) {
        qc[j] = qs[(lane + 32 * j) * (W + 1) + c];
        doc[j] = dos[(lane + 32 * j) * (W + 1) + c];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float kv = ks[(row0 + r) * W + c];
        const float vv = vs[(row0 + r) * W + c];
#pragma unroll
        for (int j = 0; j < QL; ++j) {
          s[r][j] = fmaf(qc[j], kv, s[r][j]);
          dp[r][j] = fmaf(doc[j], vv, dp[r][j]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int col = k0 + row0 + r;  // the key index
#pragma unroll
      for (int j = 0; j < QL; ++j) {
        const int qj = lane + 32 * j;
        const int row = q0 + qj;  // the query index
        const bool keep = col < tk && row < tq && (!causal || row >= col);
        const float p = prob(s[r][j], lses[qj], keep, sm_scale);
        ps[(row0 + r) * B + qj] = p;
        dss[(row0 + r) * B + qj] = p * (dp[r][j] - deltas[qj]) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the p / ds rows it wrote

    // dv += p^T do and dk += ds^T q; the lane owns columns lane + 32 c.
    for (int j = 0; j < B; ++j) {
      float dov[kCols], qv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dos[j * (W + 1) + lane + 32 * c];
        qv[c] = qs[j * (W + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pv = ps[(row0 + r) * B + j];
        const float dsv = dss[(row0 + r) * B + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[r][c] = fmaf(pv, dov[c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(dsv, qv[c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (k0 + row0 + r >= tk) continue;
    float* dkrow = dk + ((size_t)bh * tk + k0 + row0 + r) * d;
    float* dvrow = dv + ((size_t)bh * tk + k0 + row0 + r) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (lane + 32 * c >= d) continue;
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
// q rows per tile: 64 at W <= 64; 32 from W = 96 on, where the dK and dV
// accumulators take W registers a lane (up to 128, see kDkvCols).
template <int W>
constexpr int kTcBlockQ = W <= 64 ? 64 : 32;
// dK and dV columns a block accumulates: all W, but 128 at W = 256, where
// both accumulators would take all 256 registers of a lane.  There a third
// grid axis splits the output columns in two: each block computes the whole
// s^T and dp^T (over all of d) and accumulates its 128 columns of dK and dV.
template <int W>
constexpr int kDkvCols = W == 256 ? 128 : W;

template <int W>
constexpr size_t dkv_bf16_smem_bytes() {
  // k, v tiles [BK][W+8]; q, do rings [2][BQ][W+8]; lse, delta rings [2][BQ] f32;
  // per warp, 32 re-summed pairs: results (float2) and (query, key) items
  return sizeof(bf16) * (2 * kTcBlockK + 4 * kTcBlockQ<W>) * (W + 8) +
         sizeof(float) * 4 * kTcBlockQ<W> + kTcWarps * 32 * (sizeof(float2) + sizeof(uint32_t));
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
// by on sums of 64 to 128 unit-scale products (for d up to 256 the bound
// grows with |x|, as the spread of the sums does).  Values below kTieFloor
// are not screened: a flip there moves dq, dk or dv by at most 2^-15 |k|,
// |q| or |do|.  Each screened pair costs a d-step FMA chain, so the
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

__device__ __forceinline__ float2 pair_in_plain_order(const bf16* qrow, const bf16* krow,
                                                      const bf16* dorow, const bf16* vrow,
                                                      float lse, float delta, float sm_scale,
                                                      int d) {
  float s = 0.f, dp = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 8) {
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
// one, 32 a round.  Rows d long, at row stride kS elements (W + 8 for the
// shared tiles, d for rows read from device memory).
template <int N, typename Pair, typename Set>
__device__ __forceinline__ void resum_near_ties(uint32_t near, Pair pair, Set set,
                                                const bf16* qst, const bf16* dost,
                                                const bf16* kst, const bf16* vst,
                                                const float* lst, const float* dlt,
                                                uint32_t* items, float2* vals, int lane,
                                                float sm_scale, int d, int kS) {
  static_assert(N <= 32, "one bit of `near` per element");
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
      vals[lane] = pair_in_plain_order(qst + qi * kS, kst + kr * kS, dost + qi * kS,
                                       vst + kr * kS, lst[qi], dlt[qi], sm_scale, d);
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

// kExact: d is W, a compile-time constant (as in the forward kernel);
// otherwise d < W.
template <int W, bool kExact>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
                          int d_in, int causal, float sm_scale) {
  using namespace mma_bf16;
  const int d = kExact ? W : d_in;  // the tensors' row length
  constexpr int kS = W + 8;  // shared row stride, elements
  constexpr int BQ = kTcBlockQ<W>;
  constexpr int C = kDkvCols<W>;
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
  const int c0 = C == W ? 0 : blockIdx.z * C;  // this block's first dK and dV column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;  // this lane's key rows: key_lo, key_lo + 8
  const bf16* qb = q + (size_t)bh * tq * d;
  const bf16* dob = dout + (size_t)bh * tq * d;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;

  // q, do, lse and delta rows [q0, q0 + BQ) into stage st; rows past tq
  // arrive as zeros and are masked out of p below.
  auto load_q_tile = [&](int q0, int st) {
    load_rows<BQ, W, kTcThreads>(qs + st * BQ * kS, qb, q0, tq, d);
    load_rows<BQ, W, kTcThreads>(dos + st * BQ * kS, dob, q0, tq, d);
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
  float acc_dk[C / 8][4], acc_dv[C / 8][4];  // columns c0.., 8 per block
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  if (n_tiles > 0) {
    load_rows<kTcBlockK, W, kTcThreads>(ks, k + (size_t)bh * tk * d, k0, tk, d);
    load_rows<kTcBlockK, W, kTcThreads>(vs, v + (size_t)bh * tk * d, k0, tk, d);
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

    // s^T = k q^T and dp^T = v do^T: 16 keys x BQ queries a warp, over all W.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
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
      resum_near_ties<BQ / 2>(
          near,
          [&](int i) { return ((i / 4) * 8 + 2 * t + (i & 1)) | (g + (i & 2) * 4) << 8; },
          [&](int i, bool hit, float2 x) {
            s[i / 4][i % 4] = hit ? x.x : s[i / 4][i % 4];
            dp[i / 4][i % 4] = hit ? x.y : dp[i / 4][i % 4];
          },
          qst, dost, ks + warp * 16 * kS, vs + warp * 16 * kS, lst, dlt, items + warp * 32,
          vals + warp * 32, lane, sm_scale, d, kS);

    // dv += p^T do and dk += ds^T q over this block's columns: p^T and ds^T
    // rounded to bf16 in the A fragments, do and q through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
      a_from_acc(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < C / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_pair(dost, kS, kk * 16, c0 + j * 16, lane));
        mma(acc_dv[2 * j], pa, b[0], b[1]);
        mma(acc_dv[2 * j + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, bt_pair(qst, kS, kk * 16, c0 + j * 16, lane));
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
    float* dkrow = dk + ((size_t)bh * tk + key) * d + c0 + 2 * t;
    float* dvrow = dv + ((size_t)bh * tk + key) * d + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      if (c0 + j * 8 >= d) continue;  // the columns past d are zero padding
      *reinterpret_cast<float2*>(dkrow + j * 8) = make_float2(acc_dk[j][2 * h], acc_dk[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dvrow + j * 8) = make_float2(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
    }
  }
}

// dq pass.
constexpr int kDqBlockK = 64;  // key rows per tile

// 16-row m tiles a warp owns: two at W <= 64, so that each K and V fragment
// read from shared memory feeds two products; one from W = 96 on, where dq
// alone takes W / 2 registers a lane per m tile.
template <int W>
constexpr int kDqMTiles = W <= 64 ? 2 : 1;
template <int W>
constexpr int kDqBlockQ = kTcWarps * 16 * kDqMTiles<W>;  // query rows per block
// Keys per score chunk: s and dp of a chunk take 32 registers a lane each
// (16 at W = 256, beside dq's 128), one bit of the screen's mask per score.
template <int W>
constexpr int kDqChunk = W == 256 ? 32 : 64 / kDqMTiles<W>;
// The q fragments stay in registers for the whole key loop up to W = 128;
// at W = 256 they are read again from the q tile for each chunk, as the do
// fragments always are.
template <int W>
constexpr bool kDqQInRegs = W <= 128;
// Blocks an SM: two up to W = 128; at W = 256 the tiles take 200 KB.
template <int W>
constexpr int kDqMinBlocks = W == 256 ? 1 : 2;

template <int W>
constexpr size_t dq_bf16_smem_bytes() {
  // q, do tiles [BQ][W+8]; K and V rings [2][BK][W+8]; per warp, 32
  // re-summed pairs: results (float2) and (query, key) items; lse, delta [BQ] f32
  return sizeof(bf16) * (2 * kDqBlockQ<W> + 4 * kDqBlockK) * (W + 8) +
         kTcWarps * 32 * (sizeof(float2) + sizeof(uint32_t)) + sizeof(float) * 2 * kDqBlockQ<W>;
}

// Two blocks an SM up to W = 128, as the forward kernel: the q and dq
// fragments stay in registers for the whole key loop.  The do fragments are
// read again from shared memory for each chunk: kept in registers too
// (`tools/tie_variants.py dq:do_regs`), they made it no faster.  kExact: d
// is W, a compile-time constant; otherwise d < W.
template <int W, bool kExact>
__global__ void __launch_bounds__(kTcThreads, kDqMinBlocks<W>)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int tq, int tk, int d_in, int causal,
                         float sm_scale) {
  using namespace mma_bf16;
  const int d = kExact ? W : d_in;  // the tensors' row length
  constexpr int kS = W + 8;  // shared row stride, elements
  constexpr int MT = kDqMTiles<W>;
  constexpr int BQ = kDqBlockQ<W>;
  constexpr int BK = kDqBlockK;
  constexpr int KC = kDqChunk<W>;
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
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const float* lb = lse + (size_t)bh * tq + q0;  // lse and delta of the tile's rows
  const float* db = delta + (size_t)bh * tq + q0;

  // Causal: key tiles that start past this q tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;  // 0 only when tk == 0

  // lse and delta of this lane's rows; a row past tq sees no key (p = 0).
  float lse_r[MT][2], delta_r[MT][2];
  float acc[MT][W / 8][4];      // dq, 8 columns per block
  uint32_t qf[MT][kDqQInRegs<W> ? W / 16 : 1][4];  // the warp's q rows as A fragments
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
    for (int j = 0; j < W / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  if (n_tiles > 0) {
    load_rows<BQ, W, kTcThreads>(qs, q + (size_t)bh * tq * d, q0, tq, d);
    load_rows<BQ, W, kTcThreads>(dos, dout + (size_t)bh * tq * d, q0, tq, d);
    load_rows<BK, W, kTcThreads>(ks, kb, 0, tk, d);
    load_rows<BK, W, kTcThreads>(vs, vb, 0, tk, d);
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
      load_rows<BK, W, kTcThreads>(ks + (st ^ 1) * BK * kS, kb, k0 + BK, tk, d);
      load_rows<BK, W, kTcThreads>(vs + (st ^ 1) * BK * kS, vb, k0 + BK, tk, d);
    }
    cp_async_commit();  // possibly empty, so that one group always stays in flight
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kDqQInRegs<W>) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < W / 16; ++kk)
            ldmatrix_x4(qf[mt][kk], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
      }
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
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t dof[MT][4], qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4(dof[mt], a_frag(dos, kS, wrow + 16 * mt, kk * 16, lane));
          if constexpr (kDqQInRegs<W>) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[mt][e] = qf[mt][kk][e];
          } else {
            ldmatrix_x4(qa[mt], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
          }
        }
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, b_pair(kst, kS, kc + j * 16, kk * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][2 * j], qa[mt], b[0], b[1]);
            mma(s[mt][2 * j + 1], qa[mt], b[2], b[3]);
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
        resum_near_ties<MT * KC / 2>(
            near,
            [&](int i) {
              return (wrow + 16 * (i / (KC / 2)) + g + (i & 2) * 4) |
                     (kc + (i / 4) % (KC / 8) * 8 + 2 * t + (i & 1)) << 8;
            },
            [&](int i, bool hit, float2 x) {
              float& d = dp[i / (KC / 2)][(i / 4) % (KC / 8)][i % 4];
              d = hit ? x.y : d;
            },
            qs, dos, kst, vst, lses, deltas, items + warp * 32, vals + warp * 32, lane, sm_scale,
            d, kS);

      // dq += ds k: ds rounded to bf16 (k's dtype) in the A fragments, K
      // through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) a_from_acc(a[mt], dp[mt][2 * kk], dp[mt][2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
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
      float* dqrow = dq + ((size_t)bh * tq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (j * 8 < d)  // the columns past d are zero padding
          *reinterpret_cast<float2*>(dqrow + j * 8) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// d > 256 (`head_dims::wide`): the wide kernels.  A third grid axis splits
// the output columns (dq, or dk and dv).  The float32 kernels and the bf16 dq
// pass split them in blocks of kWideCols; each block sums its scores s and
// dp over the whole d by streaming the score operands through shared memory
// in chunks of kWideChunk columns (the float32 sums carry across the
// chunks), computes p and ds as the kernels above do, and multiplies them by
// its own columns of k (dq), or of do and q (dk/dv).  So every column block
// computes the same scores: the score products are done d / kWideCols
// times.  The bf16 dk/dv pass owns kWideTileCols columns a block and sums
// each score once up to d = 512 (see it below).  The tensor-core kernels
// screen p and ds as above and sum the screened pairs again from the rows in
// device memory.

constexpr int kWideChunk = head_dims::kWideChunk;
constexpr int kWideCols = head_dims::kWideCols;
constexpr int kF32WideTile = 64;  // q rows and k rows per tile of the FMA kernels

constexpr size_t dq_wide_smem_bytes() {
  // q, do chunks [B][CW]; k, v chunks [B][CW+1]; ds tile [B][B]; k columns
  // [B][OC+1]; lse, delta [B]
  constexpr int B = kF32WideTile;
  return sizeof(float) * (2 * B * kWideChunk + 2 * B * (kWideChunk + 1) + B * B +
                          B * (kWideCols + 1) + 2 * B);
}

constexpr size_t dkv_wide_smem_bytes() {
  // k, v chunks [B][CW]; q, do chunks [B][CW+1]; p, ds tiles [B][B]; q, do
  // columns [B][OC+1]; lse, delta [B]
  constexpr int B = kF32WideTile;
  return sizeof(float) * (2 * B * kWideChunk + 2 * B * (kWideChunk + 1) + 2 * B * B +
                          2 * B * (kWideCols + 1) + 2 * B);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int tq, int tk, int d, int causal,
                         float sm_scale) {
  constexpr int B = kF32WideTile, CW = kWideChunk, OC = kWideCols;
  constexpr int RW = B / kWarps;  // rows a warp owns
  constexpr int KL = B / 32;      // key columns a lane owns
  extern __shared__ float smem[];
  float* qs = smem;                   // [B][CW]
  float* dos = qs + B * CW;           // [B][CW]
  float* ks = dos + B * CW;           // [B][CW+1]
  float* vs = ks + B * (CW + 1);      // [B][CW+1]
  float* dss = vs + B * (CW + 1);     // [B][B]
  float* kcs = dss + B * B;           // [B][OC+1]
  float* lses = kcs + B * (OC + 1);   // [B]
  float* deltas = lses + B;           // [B]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const int c0 = blockIdx.z * OC;  // this block's first dq column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;
  const float* qb = q + (size_t)bh * tq * d;
  const float* dob = dout + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const bool in = q0 + i < tq;
    lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
    deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
  }

  constexpr int kCols = OC / 32;  // dq columns per lane
  float acc[RW][kCols];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const int k_end = causal ? min(tk, q0 + B) : tk;
  for (int k0 = 0; k0 < k_end; k0 += B) {
    float s[RW][KL], dp[RW][KL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < KL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int cc = 0; cc < d; cc += CW) {  // s and dp over d from 0, a chunk at a time
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int i = threadIdx.x; i < B * CW; i += kThreads) {
        const int r = i / CW, c = i % CW;
        const bool qin = q0 + r < tq && cc + c < d, kin = k0 + r < tk && cc + c < d;
        qs[i] = qin ? qb[(size_t)(q0 + r) * d + cc + c] : 0.f;
        dos[i] = qin ? dob[(size_t)(q0 + r) * d + cc + c] : 0.f;
        ks[r * (CW + 1) + c] = kin ? kb[(size_t)(k0 + r) * d + cc + c] : 0.f;
        vs[r * (CW + 1) + c] = kin ? vb[(size_t)(k0 + r) * d + cc + c] : 0.f;
      }
      __syncthreads();
      const int n = min(CW, d - cc);
      for (int c = 0; c < n; ++c) {
        float kc[KL], vc[KL];
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          kc[j] = ks[(lane + 32 * j) * (CW + 1) + c];
          vc[j] = vs[(lane + 32 * j) * (CW + 1) + c];
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float qv = qs[(row0 + r) * CW + c];
          const float dov = dos[(row0 + r) * CW + c];
#pragma unroll
          for (int j = 0; j < KL; ++j) {
            s[r][j] = fmaf(qv, kc[j], s[r][j]);
            dp[r][j] = fmaf(dov, vc[j], dp[r][j]);
          }
        }
      }
    }
    for (int i = threadIdx.x; i < B * OC; i += kThreads) {  // this block's k columns
      const int r = i / OC, c = i % OC;
      kcs[r * (OC + 1) + c] = (k0 + r < tk && c0 + c < d) ? kb[(size_t)(k0 + r) * d + c0 + c]
                                                         : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = q0 + row0 + r;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const int col = k0 + lane + 32 * j;
        const bool keep = col < tk && (!causal || row >= col);
        const float p = prob(s[r][j], lses[row0 + r], keep, sm_scale);
        dss[(row0 + r) * B + lane + 32 * j] = p * (dp[r][j] - deltas[row0 + r]) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the ds rows it wrote

    for (int j = 0; j < B; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kcs[j * (OC + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float dsv = dss[(row0 + r) * B + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsv, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (q0 + row0 + r >= tq) continue;
    float* dqrow = dq + ((size_t)bh * tq + q0 + row0 + r) * d + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + lane + 32 * c < d) dqrow[lane + 32 * c] = acc[r][c];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d,
                          int causal, float sm_scale) {
  constexpr int B = kF32WideTile, CW = kWideChunk, OC = kWideCols;
  constexpr int RW = B / kWarps;  // k rows a warp owns
  constexpr int QL = B / 32;      // query columns a lane owns
  extern __shared__ float smem[];
  float* ks = smem;                   // [B][CW]
  float* vs = ks + B * CW;            // [B][CW]
  float* qs = vs + B * CW;            // [B][CW+1]
  float* dos = qs + B * (CW + 1);     // [B][CW+1]
  float* ps = dos + B * (CW + 1);     // [B][B]
  float* dss = ps + B * B;            // [B][B]
  float* qcs = dss + B * B;           // [B][OC+1]
  float* docs = qcs + B * (OC + 1);   // [B][OC+1]
  float* lses = docs + B * (OC + 1);  // [B]
  float* deltas = lses + B;           // [B]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const int c0 = blockIdx.z * OC;  // this block's first dk and dv column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * RW;
  const float* qb = q + (size_t)bh * tq * d;
  const float* dob = dout + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  constexpr int kCols = OC / 32;
  float acc_dk[RW][kCols], acc_dv[RW][kCols];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < tq; q0 += B) {
    float s[RW][QL], dp[RW][QL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < QL; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int cc = 0; cc < d; cc += CW) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int i = threadIdx.x; i < B * CW; i += kThreads) {
        const int r = i / CW, c = i % CW;
        const bool kin = k0 + r < tk && cc + c < d, qin = q0 + r < tq && cc + c < d;
        ks[i] = kin ? kb[(size_t)(k0 + r) * d + cc + c] : 0.f;
        vs[i] = kin ? vb[(size_t)(k0 + r) * d + cc + c] : 0.f;
        qs[r * (CW + 1) + c] = qin ? qb[(size_t)(q0 + r) * d + cc + c] : 0.f;
        dos[r * (CW + 1) + c] = qin ? dob[(size_t)(q0 + r) * d + cc + c] : 0.f;
      }
      __syncthreads();
      const int n = min(CW, d - cc);
      for (int c = 0; c < n; ++c) {
        float qc[QL], doc[QL];
#pragma unroll
        for (int j = 0; j < QL; ++j) {
          qc[j] = qs[(lane + 32 * j) * (CW + 1) + c];
          doc[j] = dos[(lane + 32 * j) * (CW + 1) + c];
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float kv = ks[(row0 + r) * CW + c];
          const float vv = vs[(row0 + r) * CW + c];
#pragma unroll
          for (int j = 0; j < QL; ++j) {
            s[r][j] = fmaf(qc[j], kv, s[r][j]);
            dp[r][j] = fmaf(doc[j], vv, dp[r][j]);
          }
        }
      }
    }
    for (int i = threadIdx.x; i < B * OC; i += kThreads) {  // this block's q and do columns
      const int r = i / OC, c = i % OC;
      const bool in = q0 + r < tq && c0 + c < d;
      qcs[r * (OC + 1) + c] = in ? qb[(size_t)(q0 + r) * d + c0 + c] : 0.f;
      docs[r * (OC + 1) + c] = in ? dob[(size_t)(q0 + r) * d + c0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < B; i += kThreads) {
      const bool in = q0 + i < tq;
      lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
      deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int col = k0 + row0 + r;  // the key index
#pragma unroll
      for (int j = 0; j < QL; ++j) {
        const int qj = lane + 32 * j;
        const int row = q0 + qj;  // the query index
        const bool keep = col < tk && row < tq && (!causal || row >= col);
        const float p = prob(s[r][j], lses[qj], keep, sm_scale);
        ps[(row0 + r) * B + qj] = p;
        dss[(row0 + r) * B + qj] = p * (dp[r][j] - deltas[qj]) * sm_scale;
      }
    }
    __syncwarp();  // a warp reads back only the p / ds rows it wrote

    for (int j = 0; j < B; ++j) {
      float dov[kCols], qv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = docs[j * (OC + 1) + lane + 32 * c];
        qv[c] = qcs[j * (OC + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pv = ps[(row0 + r) * B + j];
        const float dsv = dss[(row0 + r) * B + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[r][c] = fmaf(pv, dov[c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(dsv, qv[c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (k0 + row0 + r >= tk) continue;
    float* dkrow = dk + ((size_t)bh * tk + k0 + row0 + r) * d + c0;
    float* dvrow = dv + ((size_t)bh * tk + k0 + row0 + r) * d + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c0 + lane + 32 * c >= d) continue;
      dkrow[lane + 32 * c] = acc_dk[r][c];
      dvrow[lane + 32 * c] = acc_dv[r][c];
    }
  }
}

// The tensor-core dq kernel at d > 256.  Its steps are (tile, chunk) pairs
// in order; the chunks of step i + 1 arrive through cp.async in a two-stage
// ring while step i is multiplied, and the last chunk's group of a tile also
// carries the block's columns of k (a single buffer: its previous readers
// finished a step earlier, behind a barrier, since a row takes at least five
// chunks).
constexpr int kDqWideBlockQ = kTcWarps * 16;  // query rows: one m16 tile a warp
constexpr int kDqWideBlockK = 32;             // key rows per tile

constexpr size_t dq_wide_bf16_smem_bytes() {
  // q, do chunk rings [2][BQ][CW+8] each; k, v chunk rings [2][BK][CW+8]
  // each; k columns [BK][OC+8]; per warp, 32 re-summed pairs
  return sizeof(bf16) * (4 * (kDqWideBlockQ + kDqWideBlockK) * (kWideChunk + 8) +
                         kDqWideBlockK * (kWideCols + 8)) +
         kTcWarps * 32 * (sizeof(float2) + sizeof(uint32_t));
}

__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int tq, int tk, int d, int causal,
                              float sm_scale) {
  using namespace mma_bf16;
  constexpr int CW = kWideChunk, OC = kWideCols;
  constexpr int BQ = kDqWideBlockQ, BK = kDqWideBlockK;
  constexpr int kC = CW + 8, kV = OC + 8;  // shared row strides, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [2][BQ][kC]
  bf16* dos = qs + 2 * BQ * kC;                   // [2][BQ][kC]
  bf16* ks = dos + 2 * BQ * kC;                   // [2][BK][kC]
  bf16* vs = ks + 2 * BK * kC;                    // [2][BK][kC]
  bf16* kcs = vs + 2 * BK * kC;                   // [BK][kV]
  float2* vals = reinterpret_cast<float2*>(kcs + BK * kV);              // [warps][32]
  uint32_t* items = reinterpret_cast<uint32_t*>(vals + kTcWarps * 32);  // [warps][32]

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;  // longest first
  const int c0 = blockIdx.z * OC;  // this block's first dq column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;  // this lane's rows: q0 + wrow + g + 8 h
  const bf16* qb = q + (size_t)bh * tq * d;
  const bf16* dob = dout + (size_t)bh * tq * d;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const float* lb = lse + (size_t)bh * tq + q0;  // lse and delta of the tile's rows
  const float* db = delta + (size_t)bh * tq + q0;

  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int nc = (d + CW - 1) / CW;
  const int steps = n_tiles * nc;

  auto load_step = [&](int i) {
    const int k0 = (i / nc) * BK, c = i % nc, st = i & 1;
    load_cols<BQ, CW, kTcThreads>(qs + st * BQ * kC, qb, q0, tq, c * CW, d);
    load_cols<BQ, CW, kTcThreads>(dos + st * BQ * kC, dob, q0, tq, c * CW, d);
    load_cols<BK, CW, kTcThreads>(ks + st * BK * kC, kb, k0, tk, c * CW, d);
    load_cols<BK, CW, kTcThreads>(vs + st * BK * kC, vb, k0, tk, c * CW, d);
    if (c == nc - 1) load_cols<BK, OC, kTcThreads>(kcs, kb, k0, tk, c0, d);
  };

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + g + 8 * h;
    const bool in = q0 + r < tq;
    lse_r[h] = in ? lb[r] : -CUDART_INF_F;
    delta_r[h] = in ? db[r] : 0.f;
  }
  float acc[OC / 8][4];  // dq columns c0.., 8 per block
#pragma unroll
  for (int j = 0; j < OC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float s[BK / 8][4], dp[BK / 8][4];  // the key tile's scores, summed over the chunks

  if (steps > 0) {
    load_step(0);
    cp_async_commit();
  }
  const float tie_scale = kSumErr * sm_scale;
  for (int it = 0; it < steps; ++it) {
    const int c = it % nc, st = it & 1;
    if (it + 1 < steps) load_step(it + 1);  // the stage of step i - 1, released by its barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    const bf16* qst = qs + st * BQ * kC;
    const bf16* dost = dos + st * BQ * kC;
    const bf16* kst = ks + st * BK * kC;
    const bf16* vst = vs + st * BK * kC;
#pragma unroll
    for (int kk = 0; kk < CW / 16; ++kk) {
      uint32_t qa[4], doa[4];
      ldmatrix_x4(qa, a_frag(qst, kC, wrow, kk * 16, lane));
      ldmatrix_x4(doa, a_frag(dost, kC, wrow, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair(kst, kC, j * 16, kk * 16, lane));
        mma(s[2 * j], qa, b[0], b[1]);
        mma(s[2 * j + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, b_pair(vst, kC, j * 16, kk * 16, lane));
        mma(dp[2 * j], doa, b[0], b[1]);
        mma(dp[2 * j + 1], doa, b[2], b[3]);
      }
    }
    if (c == nc - 1) {  // the tile's scores are whole: ds, then dq += ds k
      const int k0 = (it / nc) * BK;
      const bool masked = k0 + BK > tk || (causal && k0 + BK - 1 > q0);
      uint32_t near = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + wrow + g + (e >> 1) * 8;
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const bool keep = !masked || (key < tk && (!causal || row >= key));
          const float p = prob(s[j][e], lse_r[e >> 1], keep, sm_scale);
          const float ds = p * (dp[j][e] - delta_r[e >> 1]) * sm_scale;
          near |= static_cast<uint32_t>(near_ds(ds, p, sum_err(s[j][e], tie_scale),
                                                sum_err(dp[j][e], tie_scale)))
                  << (j * 4 + e);
          dp[j][e] = ds;
        }
      // Element i = j * 4 + e of dp: query row wrow + g + (i & 2) * 4 of the
      // tile, key 8 j + 2t + (i & 1) of the key tile.
      if (__any_sync(0xffffffffu, near))
        resum_near_ties<BK / 2>(
            near,
            [&](int i) { return (wrow + g + (i & 2) * 4) | ((i / 4) * 8 + 2 * t + (i & 1)) << 8; },
            [&](int i, bool hit, float2 x) {
              float& r = dp[i / 4][i % 4];
              r = hit ? x.y : r;
            },
            qb + (size_t)q0 * d, dob + (size_t)q0 * d, kb + (size_t)k0 * d,
            vb + (size_t)k0 * d, lb, db, items + warp * 32, vals + warp * 32, lane, sm_scale,
            d, d);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a_from_acc(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < OC / 16; ++j) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt_pair(kcs, kV, kk * 16, j * 16, lane));
          mma(acc[2 * j], a, b[0], b[1]);
          mma(acc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this step's stage (and the k columns) are consumed
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + g + 8 * h;
    if (row >= tq) continue;
    float* dqrow = dq + ((size_t)bh * tq + row) * d + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < OC / 8; ++j)
      if (c0 + j * 8 < d)
        *reinterpret_cast<float2*>(dqrow + j * 8) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// The tensor-core dk/dv kernel at d > 256, `flash_bwd_dkv_wide_bf16_kernel`.
// It replaces `_dkv_kernel` (polyaxon_tpu/parallel/flash.py:219) past
// head_dim 256.  What bounds it at lm_train's shape at 4 heads x 512 (BH =
// 20 x 4, T = 1024, d = 512, bf16, causal) on an H100 SXM: it reads q, k, v,
// do (4 x 83.9 MB), lse and delta (2 x 0.3 MB) and writes dk and dv (2 x
// 167.8 MB), 671.7 MB or 0.2005 ms at 3.35 TB/s, against 171.9 GFLOP of
// products (four per visible pair) or 0.1738 ms: bytes, with the products
// close behind.
//
// Design: the key tile that owns its rows owns their dk and dv columns too,
// so s^T and dp^T are summed once.  Block (bh, 32-row key tile, column
// block) owns up to kWideTileCols = 512 columns of dk and dv: all of them up
// to d = 512.  It walks the 32-row q tiles from the diagonal on; for each,
// its 8 warps
//   sum s^T = K Q^T (warps 0-3) and dp^T = V dO^T (warps 4-7) once, over the
//       whole d: each warp one 16 x 16 piece of a 32 x 32 tile (mma.sync
//       m16n8k16, ldmatrix-fed, in 16-column steps from column 0), written to
//       shared memory as float32;
//   take p^T and ds^T there, four pairs a thread, screen them and sum the
//       screened pairs again (`resum_near_ties`, from the rows in device
//       memory), and write both to shared memory as bf16 (the TPU kernel's
//       roundings of p to do's dtype and of ds to q's);
//   accumulate dv += p^T dO and dk += ds^T Q, each warp over its own 64
//       columns for all 32 keys (2 x 8 m16n8 tiles of each, 128 accumulator
//       registers a lane), p^T and ds^T through ldmatrix, dO and Q through
//       ldmatrix.trans.
// Up to d = 512 (kWhole) the k and v rows stay in shared memory for the
// block's life, and the q, do, lse and delta tiles arrive through cp.async in
// a two-stage ring, tile j + 1 in flight while tile j is used: 213 KB of
// shared memory, one block an SM.  Past 512 the column axis of the grid
// comes back (d / 512 blocks, each summing the scores again), and k, v, q
// and do stream through the ring in chunks of kWideChunk columns, the
// block's q and do columns with the last chunk of each q tile.  A cluster of
// blocks that trade partial scores through distributed shared memory would
// move about as many bytes between SMs as the repeats cost (see the forward
// kernel); one block a key tile moves none.
//
// The screen.  Each s and dp is summed as in the tensor-core kernels up to
// d = 256: one mma accumulator over d in 16-column steps from column 0, each
// step's 16 products inside the mma, against the plain version's float32
// FMAs over d from 0.  kSumErr (|x| + 16) was set on sums of 64 to 128
// products.  The two orders' difference is a walk of d roundings of partial
// sums of about sqrt(d) unit-scale products, so it grows about as d, while
// the window grows as |x|, about sqrt(d): at d 1024 it holds fewer standard
// deviations of the difference than at d 64, and no bound is claimed.  What
// it lets through is measured instead (tools/tie_variants.py, pass
// dkv_wide, at d 512 and 1024): about the same share of pairs screened in
// as at d 64, and dk and dv as close to the plain version as there, where
// without the re-summing they lie 25 to 45 times further off.  The products
// over the 32 queries of a tile are summed in the same 16-query steps as in
// the narrow kernels too.
// What holds it back now: the score products, ldmatrix-fed mma.sync below
// the wgmma rate, then three barriers a q tile with one block of 8 warps an
// SM; and the dk/dv and dq passes each read q, k, v and do.
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideTileCols = head_dims::kWideTileCols;
constexpr int kDkvWideWarpCols = kWideTileCols / kWideWarps;  // dk and dv columns a warp owns
constexpr int kDkvWideBlockK = 32;  // key rows a block owns
constexpr int kDkvWideBlockQ = 32;  // query rows a tile (the causal start needs BQ == BK)
constexpr int kDkvWideP = kDkvWideBlockQ + 8;  // row stride of the p^T and ds^T tiles (bf16)
constexpr int kDkvWideF = kDkvWideBlockQ + 4;  // and of the s^T and dp^T tiles (f32)

template <bool kWhole>
constexpr size_t dkv_wide_bf16_smem_bytes() {
  // kWhole: k, v [BK][SW+8] (loaded once), q, do rings [2][BQ][SW+8].  Else:
  // k, v, q, do rings of chunks [2][.][SW+8] and the q and do columns of the
  // block [2][BQ][OC+8].  Both: p^T, ds^T [BK][BQ+8] bf16; s^T, dp^T
  // [BK][BQ+4] f32; lse, delta rings [2][BQ] f32; per warp, 32 re-summed pairs.
  constexpr int kS = head_dims::kWideScoreCols<kWhole> + 8, kV = kWideTileCols + 8;
  constexpr int BK = kDkvWideBlockK, BQ = kDkvWideBlockQ;
  return sizeof(bf16) * ((kWhole ? 2 : 4) * BK * kS + 4 * BQ * kS + (kWhole ? 0 : 4 * BQ * kV) +
                         2 * BK * kDkvWideP) +
         sizeof(float) * (2 * BK * kDkvWideF + 4 * BQ) +
         kWideWarps * 32 * (sizeof(float2) + sizeof(uint32_t));
}

template <bool kWhole>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dkv_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
                               int d, int causal, float sm_scale) {
  using namespace mma_bf16;
  // Score columns a stage holds, and their row stride.
  constexpr int SW = head_dims::kWideScoreCols<kWhole>, kS = SW + 8;
  constexpr int OC = kWideTileCols, kV = OC + 8, WC = kDkvWideWarpCols;
  constexpr int BK = kDkvWideBlockK, BQ = kDkvWideBlockQ, kP = kDkvWideP, kF = kDkvWideF;
  // The second products' q and do rows: the staged tiles themselves when
  // they are whole, else the block's columns.
  constexpr int kC = kWhole ? kS : kV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [1 or 2][BK][kS]
  bf16* vs = ks + (kWhole ? 1 : 2) * BK * kS;    // [1 or 2][BK][kS]
  bf16* qs = vs + (kWhole ? 1 : 2) * BK * kS;    // [2][BQ][kS]
  bf16* dos = qs + 2 * BQ * kS;                  // [2][BQ][kS]
  bf16* qcs = dos + 2 * BQ * kS;                 // not kWhole: [2][BQ][kV]
  bf16* docs = qcs + (kWhole ? 0 : 2 * BQ * kV);  // not kWhole: [2][BQ][kV]
  bf16* pts = docs + (kWhole ? 0 : 2 * BQ * kV);  // [BK][kP]: p^T
  bf16* dsts = pts + BK * kP;                     // [BK][kP]: ds^T
  float* sts = reinterpret_cast<float*>(dsts + BK * kP);  // [BK][kF]: s^T
  float* dpts = sts + BK * kF;                            // [BK][kF]: dp^T
  float* lses = dpts + BK * kF;                           // [2][BQ]
  float* deltas = lses + 2 * BQ;                          // [2][BQ]
  float2* vals = reinterpret_cast<float2*>(deltas + 2 * BQ);             // [warps][32]
  uint32_t* items = reinterpret_cast<uint32_t*>(vals + kWideWarps * 32);  // [warps][32]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // low k tiles walk the most q tiles and start first
  const int c0 = blockIdx.z * OC;  // the block's first dk and dv column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // This warp's score piece: of s^T (prod 0) or dp^T (prod 1), keys 16 sm..,
  // queries 16 sn.. of the tile.
  const int prod = warp / 4, sm = (warp / 2) % 2, sn = warp % 2;
  // Its dk and dv columns wc.. of all BK keys; this lane's keys k0 + 16 mt + g + 8 h.
  const int wc = c0 + warp * WC;
  const bool has_cols = wc < d;
  // This thread's pairs of the tile: key er, queries eq..eq + 3.
  const int er = threadIdx.x / 8, eq = (threadIdx.x % 8) * 4;
  const bf16* qb = q + (size_t)bh * tq * d;
  const bf16* dob = dout + (size_t)bh * tq * d;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;

  // Causal: q tiles that end before this k tile's first row are all masked.
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + BQ - 1) / BQ : 0;
  const int nc = kWhole ? 1 : (d + SW - 1) / SW;  // chunks a q tile
  const int steps = n_tiles * nc;

  // Step i: q tile i / nc, score chunk i % nc, into stage i & 1; the block's
  // q and do columns (not kWhole), lse and delta ride with a q tile's last
  // chunk, into the buffers of its parity.  Rows past tq arrive as zeros
  // (lse -inf) and are masked out of p below.
  auto load_step = [&](int i) {
    const int j = i / nc, c = i % nc, st = i & 1, q0 = q_begin + j * BQ;
    if constexpr (!kWhole) {
      load_cols<BK, SW, kWideThreads>(ks + st * BK * kS, kb, k0, tk, c * SW, d);
      load_cols<BK, SW, kWideThreads>(vs + st * BK * kS, vb, k0, tk, c * SW, d);
    }
    load_cols<BQ, SW, kWideThreads>(qs + st * BQ * kS, qb, q0, tq, c * SW, d);
    load_cols<BQ, SW, kWideThreads>(dos + st * BQ * kS, dob, q0, tq, c * SW, d);
    if (c == nc - 1) {
      if constexpr (!kWhole) {
        load_cols<BQ, OC, kWideThreads>(qcs + (j & 1) * BQ * kV, qb, q0, tq, c0, d);
        load_cols<BQ, OC, kWideThreads>(docs + (j & 1) * BQ * kV, dob, q0, tq, c0, d);
      }
      if (threadIdx.x < 2 * BQ) {
        const int r = threadIdx.x % BQ;
        const bool in = q0 + r < tq;
        const float* src = threadIdx.x < BQ ? lb : db;
        float* dst = (threadIdx.x < BQ ? lses : deltas) + (j & 1) * BQ + r;
        cp_async4(dst, in ? src + q0 + r : src, in ? 4 : 0);
      }
    }
  };

  const float tie_scale = kSumErr * sm_scale;
  float acc_dk[2][WC / 8][4], acc_dv[2][WC / 8][4];  // keys 16 mt.., columns wc + 8 j..
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jn = 0; jn < WC / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[mt][jn][e] = acc_dv[mt][jn][e] = 0.f;
  float sc[2][4];  // the score piece, queries 16 sn + 8 n..

  if (steps > 0) {
    if constexpr (kWhole) {
      load_cols<BK, SW, kWideThreads>(ks, kb, k0, tk, 0, d);
      load_cols<BK, SW, kWideThreads>(vs, vb, k0, tk, 0, d);
    }
    load_step(0);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int j = it / nc, c = it % nc, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // step it has landed, and every warp is done with step it - 1
    if (it + 1 < steps) {
      load_step(it + 1);
      cp_async_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    }
    const bf16* ast = (prod ? vs : ks) + (kWhole ? 0 : st * BK * kS);
    const bf16* bst = (prod ? dos : qs) + st * BQ * kS;
    const int n16 = (min(SW, d - c * SW) + 15) / 16;  // columns past d are zero
#pragma unroll 4
    for (int kk = 0; kk < n16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, a_frag(ast, kS, 16 * sm, kk * 16, lane));
      ldmatrix_x4(b, b_pair(bst, kS, 16 * sn, kk * 16, lane));
      mma(sc[0], a, b[0], b[1]);
      mma(sc[1], a, b[2], b[3]);
    }
    if (c != nc - 1) continue;  // the tile's scores are whole after its last chunk

    float* xt = prod ? dpts : sts;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(xt + (16 * sm + g + 8 * h) * kF + 16 * sn + 8 * n + 2 * t) =
            make_float2(sc[n][2 * h], sc[n][2 * h + 1]);
    __syncthreads();  // s^T and dp^T are whole in shared memory

    // p^T and ds^T = p^T (dp^T - delta) scale of this thread's four pairs;
    // the mask only where the tiles cross the diagonal or a ragged end.
    const int q0 = q_begin + j * BQ;
    const float* lst = lses + (j & 1) * BQ;
    const float* dlt = deltas + (j & 1) * BQ;
    const bool masked = q0 + BQ > tq || k0 + BK > tk || (causal && q0 < k0 + BK - 1);
    const float4 s4 = *reinterpret_cast<const float4*>(sts + er * kF + eq);
    const float4 dp4 = *reinterpret_cast<const float4*>(dpts + er * kF + eq);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, dpv[4] = {dp4.x, dp4.y, dp4.z, dp4.w};
    float p[4], ds[4];
    uint32_t near = 0;  // pairs whose bf16 rounding the order of the sums could flip
    const int key = k0 + er;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = eq + e;  // the query, in the tile
      const int row = q0 + qi;
      const bool keep = !masked || (key < tk && row < tq && (!causal || row >= key));
      p[e] = prob(sv[e], lst[qi], keep, sm_scale);
      ds[e] = p[e] * (dpv[e] - dlt[qi]) * sm_scale;
      const float es = sum_err(sv[e], tie_scale);
      // bitwise, not short-circuit: no branch per pair
      const bool near_p = (p[e] >= kTieFloor) & (tie_gap(p[e]) <= p[e] * es);
      near |= static_cast<uint32_t>(near_p | near_ds(ds[e], p[e], es, sum_err(dpv[e], tie_scale)))
              << e;
    }
    // Pair i of this thread: query eq + i of the tile, key er of the block's.
    if (__any_sync(0xffffffffu, near))
      resum_near_ties<4>(
          near, [&](int i) { return (eq + i) | er << 8; },
          [&](int i, bool hit, float2 x) {
            p[i] = hit ? x.x : p[i];
            ds[i] = hit ? x.y : ds[i];
          },
          qb + (size_t)q0 * d, dob + (size_t)q0 * d, kb + (size_t)k0 * d, vb + (size_t)k0 * d,
          lst, dlt, items + warp * 32, vals + warp * 32, lane, sm_scale, d, d);
    *reinterpret_cast<uint2*>(pts + er * kP + eq) =
        make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
    *reinterpret_cast<uint2*>(dsts + er * kP + eq) =
        make_uint2(pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]));
    __syncthreads();  // p^T and ds^T are whole in shared memory

    // dv += p^T do and dk += ds^T q over this warp's columns.
    if (has_cols) {
      const bf16* qct = kWhole ? qs + st * BQ * kS : qcs + (j & 1) * BQ * kV;
      const bf16* doct = kWhole ? dos + st * BQ * kS : docs + (j & 1) * BQ * kV;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(pa[mt], a_frag(pts, kP, 16 * mt, kk * 16, lane));
          ldmatrix_x4(da[mt], a_frag(dsts, kP, 16 * mt, kk * 16, lane));
        }
#pragma unroll
        for (int jp = 0; jp < WC / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt_pair(doct, kC, kk * 16, wc - c0 + jp * 16, lane));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc_dv[mt][2 * jp], pa[mt], b[0], b[1]);
            mma(acc_dv[mt][2 * jp + 1], pa[mt], b[2], b[3]);
          }
          ldmatrix_x4_trans(b, bt_pair(qct, kC, kk * 16, wc - c0 + jp * 16, lane));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc_dk[mt][2 * jp], da[mt], b[0], b[1]);
            mma(acc_dk[mt][2 * jp + 1], da[mt], b[2], b[3]);
          }
        }
      }
    }
  }

  if (!has_cols) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + 16 * mt + g + 8 * h;
      if (key >= tk) continue;
      float* dkrow = dk + ((size_t)bh * tk + key) * d + wc + 2 * t;
      float* dvrow = dv + ((size_t)bh * tk + key) * d + wc + 2 * t;
#pragma unroll
      for (int jn = 0; jn < WC / 8; ++jn) {
        if (wc + jn * 8 >= d) continue;  // the columns past d are zero padding
        *reinterpret_cast<float2*>(dkrow + jn * 8) =
            make_float2(acc_dk[mt][jn][2 * h], acc_dk[mt][jn][2 * h + 1]);
        *reinterpret_cast<float2*>(dvrow + jn * 8) =
            make_float2(acc_dv[mt][jn][2 * h], acc_dv[mt][jn][2 * h + 1]);
      }
    }
}

// One launch of a kernel of either pass: its dynamic shared memory raised to
// smem, the inputs cast to T, then the outputs.
template <typename T, typename Kernel, typename... Out>
cudaError_t launch(Kernel kernel, size_t smem, int threads, dim3 grid, const void* q,
                   const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int tq, int tk, int d, int causal, float sm_scale,
                   cudaStream_t stream, Out*... out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, out..., tq, tk, d, causal, sm_scale);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, int bh, int tq, int tk,
                      int d, int causal, float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_bwd_dq_kernel<W>, dq_smem_bytes<W>(), kThreads,
                         dim3(bh, (tq + kF32Tile<W> - 1) / kF32Tile<W>), q, k, v, dout, lse,
                         delta, tq, tk, d, causal, sm_scale, stream, dq);
  return launch<bf16>(d == W ? flash_bwd_dq_bf16_kernel<W, true>
                             : flash_bwd_dq_bf16_kernel<W, false>,
                      dq_bf16_smem_bytes<W>(), kTcThreads,
                      dim3(bh, (tq + kDqBlockQ<W> - 1) / kDqBlockQ<W>), q, k, v, dout, lse,
                      delta, tq, tk, d, causal, sm_scale, stream, dq);
}

template <int W>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int tq, int tk, int d, int causal, float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_bwd_dkv_kernel<W>, dkv_smem_bytes<W>(), kThreads,
                         dim3(bh, (tk + kF32Tile<W> - 1) / kF32Tile<W>), q, k, v, dout, lse,
                         delta, tq, tk, d, causal, sm_scale, stream, dk, dv);
  return launch<bf16>(d == W ? flash_bwd_dkv_bf16_kernel<W, true>
                             : flash_bwd_dkv_bf16_kernel<W, false>,
                      dkv_bf16_smem_bytes<W>(), kTcThreads,
                      dim3(bh, (tk + kTcBlockK - 1) / kTcBlockK, W / kDkvCols<W>), q, k, v,
                      dout, lse, delta, tq, tk, d, causal, sm_scale, stream, dk, dv);
}

cudaError_t launch_dq_wide(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* delta, float* dq,
                           int bh, int tq, int tk, int d, int causal, float sm_scale,
                           cudaStream_t stream) {
  const int blocks = head_dims::wide_blocks(d, kWideCols);
  if (dtype == 0)
    return launch<float>(flash_bwd_dq_wide_kernel, dq_wide_smem_bytes(), kThreads,
                         dim3(bh, (tq + kF32WideTile - 1) / kF32WideTile, blocks), q, k, v,
                         dout, lse, delta, tq, tk, d, causal, sm_scale, stream, dq);
  return launch<bf16>(flash_bwd_dq_wide_bf16_kernel, dq_wide_bf16_smem_bytes(), kTcThreads,
                      dim3(bh, (tq + kDqWideBlockQ - 1) / kDqWideBlockQ, blocks), q, k, v, dout,
                      lse, delta, tq, tk, d, causal, sm_scale, stream, dq);
}

// The bf16 wide dk/dv kernel's launch for (bh, tk, d): launch_dkv_wide makes
// it and flash_bwd_dkv_wide_bf16_shape reports it.
struct DkvWideLaunch {
  decltype(&flash_bwd_dkv_wide_bf16_kernel<true>) kernel;
  dim3 grid;
  int threads;
  size_t smem;
};

DkvWideLaunch dkv_wide_bf16_launch(int bh, int tk, int d) {
  const bool whole = d <= kWideTileCols;
  return {whole ? flash_bwd_dkv_wide_bf16_kernel<true> : flash_bwd_dkv_wide_bf16_kernel<false>,
          dim3(bh, (tk + kDkvWideBlockK - 1) / kDkvWideBlockK,
               head_dims::wide_blocks(d, kWideTileCols)),
          kWideThreads,
          whole ? dkv_wide_bf16_smem_bytes<true>() : dkv_wide_bf16_smem_bytes<false>()};
}

cudaError_t launch_dkv_wide(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta, float* dk,
                            float* dv, int bh, int tq, int tk, int d, int causal,
                            float sm_scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_bwd_dkv_wide_kernel, dkv_wide_smem_bytes(), kThreads,
                         dim3(bh, (tk + kF32WideTile - 1) / kF32WideTile,
                              head_dims::wide_blocks(d, kWideCols)),
                         q, k, v, dout, lse, delta, tq, tk, d, causal, sm_scale, stream, dk, dv);
  const DkvWideLaunch l = dkv_wide_bf16_launch(bh, tk, d);
  return launch<bf16>(l.kernel, l.smem, l.threads, l.grid, q, k, v, dout, lse, delta, tq, tk, d,
                      causal, sm_scale, stream, dk, dv);
}

using DqFn = decltype(&launch_dq<64>);
using DkvFn = decltype(&launch_dkv<64>);

// Each pass's launcher at the tile width that holds d.
DqFn dq_at_width(int d) {
  if (head_dims::wide(d)) return launch_dq_wide;
  switch (head_dims::tile_width(d)) {
    case 32: return launch_dq<32>;
    case 64: return launch_dq<64>;
    case 96: return launch_dq<96>;
    case 128: return launch_dq<128>;
    default: return launch_dq<256>;
  }
}

DkvFn dkv_at_width(int d) {
  if (head_dims::wide(d)) return launch_dkv_wide;
  switch (head_dims::tile_width(d)) {
    case 32: return launch_dkv<32>;
    case 64: return launch_dkv<64>;
    case 96: return launch_dkv<96>;
    case 128: return launch_dkv<128>;
    default: return launch_dkv<256>;
  }
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 = float32 (the FMA
// kernels), 1 = bfloat16 (the tensor-core kernels); d a multiple of 8 (the
// wide kernels past 256).  The caller has checked shapes, types, contiguity and 16-byte
// alignment, launches the dq pass only when bh > 0 and tq > 0 and the dk/dv
// pass only when bh > 0 and tk > 0.  Each returns its launch's CUDA error
// code (0 = none).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, int causal, float sm_scale,
                            void* stream) {
  if ((dtype != 0 && dtype != 1) || !head_dims::takes(d)) return cudaErrorInvalidValue;
  return dq_at_width(d)(dtype, q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<float*>(dq), bh, tq, tk,
                        d, causal, sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  if ((dtype != 0 && dtype != 1) || !head_dims::takes(d)) return cudaErrorInvalidValue;
  return dkv_at_width(d)(dtype, q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta), static_cast<float*>(dk),
                         static_cast<float*>(dv), bh, tq, tk, d, causal, sm_scale,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 wide dk/dv kernel's launch for (bh, tk, d), d past 256, as
// launch_dkv_wide makes it, for the logs: out[0..5] = grid x, y, z, threads a
// block, dynamic shared memory bytes and registers a thread
// (cudaFuncGetAttributes).  Returns its CUDA error code.
extern "C" int flash_bwd_dkv_wide_bf16_shape(int bh, int tk, int d, int* out) {
  if (!head_dims::takes(d) || !head_dims::wide(d)) return cudaErrorInvalidValue;
  const DkvWideLaunch l = dkv_wide_bf16_launch(bh, tk, d);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return err;
  const int got[6] = {(int)l.grid.x, (int)l.grid.y, (int)l.grid.z, l.threads, (int)l.smem,
                      attr.numRegs};
  for (int i = 0; i < 6; ++i) out[i] = got[i];
  return cudaSuccess;
}
