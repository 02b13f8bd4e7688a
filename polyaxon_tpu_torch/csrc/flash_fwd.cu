// Causal / non-causal flash attention forward for one block: Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of polyaxon_tpu/parallel/flash.py
// (called there through `flash_block_fwd`).  Same function:
//   o   = softmax(q k^T * sm_scale [causal mask]) v, normalised, float32
//   lse = log-sum-exp of the masked, scaled scores, float32, [BH, Tq]
// with q [BH, Tq, d], k/v [BH, Tk, d] (bf16 or f32, contiguous, 16-byte
// aligned), d a multiple of 8 from 8 to 256 (`head_dims.cuh`: each kernel
// is compiled for tile widths W of 32, 64, 96, 128 and 256 and runs at the
// least W >= d; columns d..W are zero in shared memory and never stored).
// Causal masking assumes q and k share one global
// offset (row >= col), masks with -1e30 and skips key tiles wholly above the
// diagonal.  A row with no visible key gets lse = -inf and o = 0.  p is
// rounded to the input type before P.V, as the TPU kernel rounds it to v's
// dtype; l sums the unrounded p; all sums are float32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//   prefill of the 671M model (BH = 4 x 32, T = 512, d = 64, bf16, causal):
//     42.2 MB moved (q, k, v read, o f32 and lse written), 12.6 us, against
//     4.3 GFLOP of products over the visible pairs, 4.4 us: bytes.
//   training (BH = 20 x 32, T = 1024): 422.1 MB, 126.0 us, against 86.1
//     GFLOP, 87.0 us: bytes, with the products close behind.
//   training at head_dim 96 (BH = 20 x 32): 631.8 MB, 188.6 us, against
//     129.0 GFLOP; at 256 (BH = 20 x 8): 420.1 MB, 125.4 us, against 86.0
//     GFLOP: bytes.
//
// Design.  The code is picked by dtype; that is dispatch by type, not a
// fallback: bf16 inputs run the tensor-core kernel, float32 inputs the FMA
// kernel (tensor cores would need TF32 there, a different result).
//
// bf16, `flash_fwd_bf16_kernel` (FlashAttention-2 on mma.sync): block
// (bh, q tile) owns 128 query rows at W <= 64 (4 warps of 32 rows, two m16
// tiles each, so every K and V fragment read from shared memory feeds two
// products) and 64 at W >= 96 (16 rows a warp: registers), and walks the
// key tiles (64 rows; 32 at W = 256) up to the diagonal, so the [T, T]
// scores never reach device memory.  The q tile is staged once and kept in
// registers as mma A fragments up to W = 128; at W = 256 the o accumulator
// alone takes 128 registers a lane, so the q fragments are read again from
// shared memory for each key tile, and the 32-row key tiles keep two blocks
// on an SM (101 KB of shared memory each).  K and V tiles arrive as bf16
// through cp.async into a two-stage ring, tile j + 1 in flight while tile j
// is multiplied.  S = Q K^T
// and O += P V are mma.sync m16n8k16 bf16 products with float32 sums, fed by
// ldmatrix (.trans for V); shared rows are padded by 16 bytes so each
// ldmatrix hits every bank once.  The online softmax runs on the S
// accumulator fragments: each row's max and sum are shuffles across the 4
// lanes that hold it, and p becomes the bf16 A fragment of P.V in registers
// (that conversion is the TPU kernel's p.astype(v.dtype)), so p never goes
// through shared memory; exp is taken as exp2 of a scaled argument.  The
// mask is applied only on the key tiles that cross the diagonal (two per q
// tile at W <= 64) or the ragged end; out-of-range rows load as zeros and are never
// written.  Causal q tiles are scheduled longest first (reversed
// blockIdx.y), so the short tiles fill the tail.  What holds it back now:
// mma.sync issues at about two thirds of the wgmma rate, the o tile is
// stored from the accumulator layout (32 bytes per row per quad) rather than
// through shared memory, and nothing overlaps one tile's softmax with the
// next tile's products (no warp specialisation).
//
// float32, `flash_fwd_f32_kernel`: the same walk with 8 warps of 8 rows,
// tiles staged in shared memory as float32 and plain FMA products; bound by
// its own instruction rate.  It serves the small float32 correctness runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_dims.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegBig = -1e30f;  // the TPU kernel's mask value

// ---------------------------------------------------------------------------
// float32: FMA kernel.

constexpr int kF32BlockQ = 64;  // query rows per thread block
constexpr int kF32BlockK = 64;  // key rows per tile
constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32RowsPerWarp = kF32BlockQ / kF32Warps;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int W>
constexpr size_t f32_smem_bytes() {
  // q tile [BQ][W], k tile [BK][W+1], v tile [BK][W], p tile [BQ][BK]
  return sizeof(float) *
         (kF32BlockQ * W + kF32BlockK * (W + 1) + kF32BlockK * W + kF32BlockQ * kF32BlockK);
}

// Tiles of W columns; the tensors' rows are d long (d <= W), the columns
// past d zero in shared memory.
template <int W>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, int d, int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kF32BlockQ * W;
  float* vs = ks + kF32BlockK * (W + 1);
  float* ps = vs + kF32BlockK * W;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kF32BlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kF32RowsPerWarp;  // this warp's first row in the tile
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  for (int i = threadIdx.x; i < kF32BlockQ * W; i += kF32Threads) {
    const int r = i / W, c = i % W;
    qs[i] = (q0 + r < tq && c < d) ? qb[(size_t)(q0 + r) * d + c] : 0.f;
  }

  constexpr int kCols = W / 32;  // output columns per lane
  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // Causal: key tiles that start past this q-tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + kF32BlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kF32BlockK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is stored)
    for (int i = threadIdx.x; i < kF32BlockK * W; i += kF32Threads) {
      const int r = i / W, c = i % W;
      const bool in = k0 + r < tk && c < d;
      ks[r * (W + 1) + c] = in ? kb[(size_t)(k0 + r) * d + c] : 0.f;
      vs[i] = in ? vb[(size_t)(k0 + r) * d + c] : 0.f;
    }
    __syncthreads();

    // s = q k^T for this warp's rows; the lane owns key columns lane, lane+32.
    float s[kF32RowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < d; ++c) {  // the zero columns past d add nothing
      const float k_lo = ks[lane * (W + 1) + c];
      const float k_hi = ks[(lane + 32) * (W + 1) + c];
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        const float qv = qs[(row0 + r) * W + c];
        s[r][0] = fmaf(qv, k_lo, s[r][0]);
        s[r][1] = fmaf(qv, k_hi, s[r][1]);
      }
    }

    // Online softmax, one row at a time (the whole warp shares a row).
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
      bool keep[2];
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        keep[j] = col < tk && (!causal || row >= col);
        sv[j] = keep[j] ? s[r][j] * sm_scale : kNegBig;
      }
      const float m_cur = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m[r] - m_cur);  // m = -inf on the first tile -> 0
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) p[j] = keep[j] ? expf(sv[j] - m_cur) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[(row0 + r) * kF32BlockK + lane + 32 * j] = p[j];
    }
    __syncwarp();  // a warp reads back only the p rows it wrote

    // acc += p v; the lane owns output columns lane + 32 c.
    for (int j = 0; j < kF32BlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * W + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        const float pv = ps[(row0 + r) * kF32BlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pv, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= tq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < d) orow[lane + 32 * c] = acc[r][c] / safe;
    if (lane == 0)
      lse[(size_t)bh * tq + row] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-38f)) : -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// 16-row m tiles a warp owns: two at W <= 64, so that each K and V fragment
// read from shared memory feeds two products; one from W = 96 on, where the
// o accumulator alone takes W / 2 registers a lane per m tile.
template <int W>
constexpr int kMTiles = W <= 64 ? 2 : 1;
template <int W>
constexpr int kBlockQ = kWarps * 16 * kMTiles<W>;  // query rows per thread block
// Key rows per tile: 32 at W = 256, so that the q tile and the two-stage K
// and V rings (101 KB) leave room for a second block on the SM.
template <int W>
constexpr int kBlockK = W == 256 ? 32 : 64;
// The q fragments stay in registers for the whole key loop up to W = 128
// (W / 4 registers a lane per m tile); at W = 256 they are read again from
// the q tile for each key tile, beside the 128 registers of o.
template <int W>
constexpr bool kQInRegs = W <= 128;

template <int W>
constexpr size_t bf16_smem_bytes() {
  // q tile [BQ][W+8], then K and V rings [2][BK][W+8] each
  return sizeof(bf16) * (kBlockQ<W> + 4 * kBlockK<W>) * (W + 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two blocks an SM at least: with that bound ptxas uses the registers the
// accumulators need (with none it settled on 128 and spilled).  kExact: d
// is W, and the kernel takes it as a compile-time constant (with a runtime
// row length the d = 64 forward ran about 30% slower on an H100); otherwise
// d < W.
template <int W, bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int d_in, int causal,
                      float sm_scale) {
  using namespace mma_bf16;
  const int d = kExact ? W : d_in;  // the tensors' row length
  constexpr int kS = W + 8;  // shared row stride, elements
  constexpr int MT = kMTiles<W>;
  constexpr int BQ = kBlockQ<W>;
  constexpr int BK = kBlockK<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * kS;       // [2][BK][kS]
  bf16* vs = ks + 2 * BK * kS;   // [2][BK][kS]

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16 * MT;  // this warp's first row in the tile
  // This lane's rows: q0 + wrow + 16 mt + g + 8 h, for m tile mt and half h.
  const bf16* qb = q + (size_t)bh * tq * d;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;

  // Causal: key tiles that start past this q tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;  // 0 only when tk == 0

  float m[MT][2], l[MT][2];  // running max; this lane's part of each row sum
  float acc[MT][W / 8][4];   // o, 8 columns per block
  uint32_t qf[MT][kQInRegs<W> ? W / 16 : 1][4];  // the warp's q rows as A fragments
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  if (n_tiles > 0) {
    load_rows<BQ, W, kThreads>(qs, qb, q0, tq, d);
    load_rows<BK, W, kThreads>(ks, kb, 0, tk, d);
    load_rows<BK, W, kThreads>(vs, vb, 0, tk, d);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the stage read in iteration it - 1, released by its last barrier
      load_rows<BK, W, kThreads>(ks + (st ^ 1) * BK * kS, kb, k0 + BK, tk, d);
      load_rows<BK, W, kThreads>(vs + (st ^ 1) * BK * kS, vb, k0 + BK, tk, d);
    }
    cp_async_commit();  // possibly empty, so that one group always stays in flight
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQInRegs<W>) {
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

    // s = q k^T: 16 MT rows x BK keys a warp, 8 key columns per block.
    float s[MT][BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t a[MT][4];  // q's A fragments of columns kk * 16..
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQInRegs<W>) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          ldmatrix_x4(a[mt], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair(kst, kS, j * 16, kk * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * j], a[mt], b[0], b[1]);
          mma(s[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // Scale, and mask where the tile crosses the diagonal or the ragged end.
    const bool masked = k0 + BK > tk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] *= sm_scale;
          if (masked) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = q0 + wrow + 16 * mt + g + (e >> 1) * 8;
            if (!(col < tk && (!causal || row >= col))) s[mt][j][e] = kNegBig;
          }
        }

    // Online softmax on the accumulator fragments; s becomes p in place.
    // exp(x - m) is taken as exp2((x - m) log2 e), one FMA and one ex2.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[mt][h];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
        const float m_cur = quad_max(mx);
        const float alpha = exp2f((m[mt][h] - m_cur) * kLog2e);  // m = -inf on the first tile -> 0
        const float m_log2 = m_cur * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            // A masked score is exactly kNegBig; it gets p = 0 as in the FMA kernel.
            const float x = s[mt][j][e];
            const float p = x == kNegBig && masked ? 0.f : exp2f(fmaf(x, kLog2e, -m_log2));
            s[mt][j][e] = p;
            sum += p;
          }
        l[mt][h] = l[mt][h] * alpha + sum;
        m[mt][h] = m_cur;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          acc[mt][j][2 * h] *= alpha;
          acc[mt][j][2 * h + 1] *= alpha;
        }
      }

    // o += p v: p (rounded to bf16 here) is the A operand, V via ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a_from_acc(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_pair(vst, kS, kk * 16, j * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * j], a[mt], b[0], b[1]);
          mma(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
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
      const float l_row = quad_sum(l[mt][h]);
      if (row >= tq) continue;
      const float safe = l_row > 0.f ? l_row : 1.f;
      float* orow = o + ((size_t)bh * tq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        if (j * 8 < d)  // the columns past d are zero padding
          *reinterpret_cast<float2*>(orow + j * 8) =
              make_float2(acc[mt][j][2 * h] / safe, acc[mt][j][2 * h + 1] / safe);
      if (t == 0)
        lse[(size_t)bh * tq + row] =
            l_row > 0.f ? m[mt][h] + logf(fmaxf(l_row, 1e-38f)) : -CUDART_INF_F;
    }
}

// ---------------------------------------------------------------------------
// d > 256 (`head_dims::wide`): the wide kernels.  A third grid axis runs
// column blocks of the output.  The float32 kernel's block (bh, q tile,
// column block) owns kWideCols output columns of its rows, sums its scores
// S = Q K^T over the whole d, streaming q and k through shared memory in
// chunks of kWideChunk columns (the float32 sums carry across the chunks),
// applies the online softmax as the kernels above do, and multiplies p by
// its own columns of V only: every column block computes the same S, d /
// kWideCols times.  The bf16 kernel's blocks own kWideTileCols columns (see
// below).  Only column block 0 writes lse.

constexpr int kWideChunk = head_dims::kWideChunk;
constexpr int kWideCols = head_dims::kWideCols;

constexpr size_t f32_wide_smem_bytes() {
  // q chunk [BQ][CW], k chunk [BK][CW+1], v columns [BK][OC], p tile [BQ][BK]
  return sizeof(float) * (kF32BlockQ * kWideChunk + kF32BlockK * (kWideChunk + 1) +
                          kF32BlockK * kWideCols + kF32BlockQ * kF32BlockK);
}

__global__ void __launch_bounds__(kF32Threads)
flash_fwd_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int tq, int tk, int d, int causal,
                          float sm_scale) {
  constexpr int CW = kWideChunk, OC = kWideCols;
  extern __shared__ float smem[];
  float* qs = smem;                     // [BQ][CW]
  float* ks = qs + kF32BlockQ * CW;     // [BK][CW+1]
  float* vs = ks + kF32BlockK * (CW + 1);  // [BK][OC]
  float* ps = vs + kF32BlockK * OC;     // [BQ][BK]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kF32BlockQ;
  const int c0 = blockIdx.z * OC;  // this block's first output column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kF32RowsPerWarp;
  const float* qb = q + (size_t)bh * tq * d;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  constexpr int kCols = OC / 32;  // output columns per lane
  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + kF32BlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kF32BlockK) {
    float s[kF32RowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int cc = 0; cc < d; cc += CW) {  // s over d from 0, one chunk at a time
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int i = threadIdx.x; i < kF32BlockQ * CW; i += kF32Threads) {
        const int r = i / CW, c = i % CW;
        qs[i] = (q0 + r < tq && cc + c < d) ? qb[(size_t)(q0 + r) * d + cc + c] : 0.f;
        ks[r * (CW + 1) + c] = (k0 + r < tk && cc + c < d) ? kb[(size_t)(k0 + r) * d + cc + c]
                                                           : 0.f;
      }
      __syncthreads();
      const int n = min(CW, d - cc);
      for (int c = 0; c < n; ++c) {
        const float k_lo = ks[lane * (CW + 1) + c];
        const float k_hi = ks[(lane + 32) * (CW + 1) + c];
#pragma unroll
        for (int r = 0; r < kF32RowsPerWarp; ++r) {
          const float qv = qs[(row0 + r) * CW + c];
          s[r][0] = fmaf(qv, k_lo, s[r][0]);
          s[r][1] = fmaf(qv, k_hi, s[r][1]);
        }
      }
    }
    // This block's columns of the v tile (the chunk loop's barriers keep the
    // previous tile's readers behind).
    for (int i = threadIdx.x; i < kF32BlockK * OC; i += kF32Threads) {
      const int r = i / OC, c = i % OC;
      vs[i] = (k0 + r < tk && c0 + c < d) ? vb[(size_t)(k0 + r) * d + c0 + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
      bool keep[2];
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        keep[j] = col < tk && (!causal || row >= col);
        sv[j] = keep[j] ? s[r][j] * sm_scale : kNegBig;
      }
      const float m_cur = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m[r] - m_cur);
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) p[j] = keep[j] ? expf(sv[j] - m_cur) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[(row0 + r) * kF32BlockK + lane + 32 * j] = p[j];
    }
    __syncwarp();

    for (int j = 0; j < kF32BlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * OC + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        const float pv = ps[(row0 + r) * kF32BlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pv, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= tq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    float* orow = o + ((size_t)bh * tq + row) * d + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + lane + 32 * c < d) orow[lane + 32 * c] = acc[r][c] / safe;
    if (lane == 0 && blockIdx.z == 0)
      lse[(size_t)bh * tq + row] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-38f)) : -CUDART_INF_F;
  }
}

// The tensor-core kernel at d > 256, `flash_fwd_wide_bf16_kernel`.  It
// replaces `_fwd_kernel` (polyaxon_tpu/parallel/flash.py:58) past head_dim
// 256.  What bounds it at lm_train's shape at 4 heads x 512 (BH = 20 x 4,
// T = 1024, d = 512, bf16, causal) on an H100 SXM: 419.8 MB moved (q, k, v
// read, o f32 and lse written), 0.1253 ms at 3.35 TB/s, against 86.0 GFLOP
// of products over the visible pairs, 0.0869 ms at 989 TFLOP/s: bytes.
//
// Design: the tile that owns its rows owns their output columns too, so
// each score is summed once.  Block (bh, 64-row q tile, column block) owns
// up to kWideTileCols = 512 output columns: all of them up to d = 512.  Its
// 8 warps split the scores and the output between them:
//   S = Q K^T   for a 32-row key tile is summed once over the whole d: warp
//               w sums rows 16 (w % 4).. of the 64 x 32 tile over one half
//               (w / 4) of d's 16-column steps, mma.sync m16n8k16 fed by
//               ldmatrix, four accumulator chains a warp; the second half's
//               partial sums reach the first half's warps through shared
//               memory;
//   softmax     warps 0-3 then own the rows: the online softmax on their
//               fragments (running max m and sum l in registers), p = exp(s
//               - m) written to shared memory as bf16 (the TPU kernel's
//               p.astype(v.dtype)), l summing the unrounded p, and each
//               row's alpha = exp(m_old - m) beside it;
//   O += P V    each warp owns 64 of the block's columns for all 64 rows
//               (4 x 8 m16n8 tiles, 128 accumulator registers a lane),
//               rescales them by the rows' alpha, and reads the whole p tile
//               and its own columns of V.
// Up to d = 512 (kWhole) the q tile stays in shared memory for the whole
// key loop (64 KB, loaded once), and K and V tiles of 32 rows arrive through
// cp.async in a two-stage ring, tile j + 1 in flight while tile j is used:
// 210 KB of shared memory, one block an SM.  Past 512 the column axis of the
// grid comes back (d / 512 blocks, each summing S again) and q and k stream
// through the ring in chunks of kWideChunk columns, the block's V columns
// with the last chunk of each key tile.  A thread-block cluster of d / 128
// blocks that trade partial S through distributed shared memory would also
// sum each score once, but at this shape it would move about 2 GB of 64 x
// 64 float32 partials between SMs a call, about as long as the repeats it
// saves; one block a row tile moves nothing.  What holds it back now: a
// key-tile step that all 8 warps walk in step, three barriers apart, with
// nothing to overlap it (one block an SM), in which issuing the next tile's
// 64 KB of cp.async stalls under the memory system's back-pressure (spread
// over the S products, the copies stalled those and the kernel ran slower).
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideTileCols = head_dims::kWideTileCols;
constexpr int kWideWarpCols = kWideTileCols / kWideWarps;  // output columns a warp owns
constexpr int kWideBlockQ = 64;                            // query rows a block owns
constexpr int kWideBlockK = 32;                            // key rows a tile
constexpr int kWideP = kWideBlockK + 8;                    // the p tile's row stride (bf16)
constexpr int kWideX = kWideBlockK + 4;                    // the partial scores' row stride (f32)

template <bool kWhole>
constexpr size_t bf16_wide_smem_bytes() {
  // q [BQ][SW+8] (kWhole: loaded once; else a two-stage ring of chunks),
  // K ring [2][BK][SW+8], V ring [2][BK][OC+8], p tile [BQ][BK+8] bf16; the
  // second half's partial scores [BQ][BK+4], each row's alpha and sum [BQ] f32
  constexpr int kS = head_dims::kWideScoreCols<kWhole> + 8;
  return sizeof(bf16) * ((kWhole ? 1 : 2) * kWideBlockQ * kS + 2 * kWideBlockK * kS +
                         2 * kWideBlockK * (kWideTileCols + 8) + kWideBlockQ * kWideP) +
         sizeof(float) * (kWideBlockQ * kWideX + 2 * kWideBlockQ);
}

template <bool kWhole>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int tq, int tk, int d, int causal,
                           float sm_scale) {
  using namespace mma_bf16;
  // Score columns a stage holds, and their row stride.
  constexpr int SW = head_dims::kWideScoreCols<kWhole>, kS = SW + 8;
  constexpr int BQ = kWideBlockQ, BK = kWideBlockK, OC = kWideTileCols, kV = OC + 8;
  constexpr int WC = kWideWarpCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);             // [1 or 2][BQ][kS]
  bf16* ks = qs + (kWhole ? 1 : 2) * BQ * kS;               // [2][BK][kS]
  bf16* vs = ks + 2 * BK * kS;                              // [2][BK][kV]
  bf16* ps = vs + 2 * BK * kV;                              // [BQ][kWideP]
  float* xs = reinterpret_cast<float*>(ps + BQ * kWideP);   // [BQ][kWideX]
  float* alphas = xs + BQ * kWideX;                         // [BQ]
  float* sums = alphas + BQ;                                // [BQ]

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;  // longest first
  const int c0 = blockIdx.z * OC;  // the block's first output column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // This warp's scores: rows 16 sm.. of the tile, all BK keys, over half
  // (hf) of each chunk's 16-column steps.  The warps of half 0 then own the
  // rows' softmax: this lane's rows 16 sm + g + 8 h.
  const int sm = warp % 4, hf = warp / 4;
  // Its output columns wc.. of all BQ rows; this lane's rows 16 mt + g + 8 h.
  const int wc = c0 + warp * WC;
  const bool has_cols = wc < d;
  const bf16* qb = q + (size_t)bh * tq * d;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;

  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;  // 0 only when tk == 0
  const int nc = kWhole ? 1 : (d + SW - 1) / SW;  // chunks a key tile
  const int steps = n_tiles * nc;

  // Step i: key tile i / nc, score chunk i % nc, into stage i & 1; the V
  // columns ride with a key tile's last chunk, into the V stage of its parity.
  auto load_step = [&](int i) {
    const int j = i / nc, c = i % nc, st = i & 1;
    if constexpr (!kWhole) load_cols<BQ, SW, kWideThreads>(qs + st * BQ * kS, qb, q0, tq, c * SW, d);
    load_cols<BK, SW, kWideThreads>(ks + st * BK * kS, kb, j * BK, tk, c * SW, d);
    if (c == nc - 1) load_cols<BK, OC, kWideThreads>(vs + (j & 1) * BK * kV, vb, j * BK, tk, c0, d);
  };

  float m[2], l[2];         // half 0: running max and sum of this lane's rows
  float acc[4][WC / 8][4];  // o, rows 16 mt.., columns wc + 8 j..
  float s[BK / 8][4];       // the scores, keys 8 n..
  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < WC / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  if (steps > 0) {
    if constexpr (kWhole) load_cols<BQ, SW, kWideThreads>(qs, qb, q0, tq, 0, d);
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
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    const bf16* qst = kWhole ? qs : qs + st * BQ * kS;
    const bf16* kst = ks + st * BK * kS;
    const int n16 = (min(SW, d - c * SW) + 15) / 16;  // columns past d are zero
    const int mid = (n16 + 1) / 2;
#pragma unroll 4
    for (int kk = hf ? mid : 0; kk < (hf ? n16 : mid); ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag(qst, kS, 16 * sm, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair(kst, kS, 16 * n, kk * 16, lane));
        mma(s[2 * n], a, b[0], b[1]);
        mma(s[2 * n + 1], a, b[2], b[3]);
      }
    }
    if (c != nc - 1) continue;  // the tile's scores are whole after its last chunk

    if (hf) {  // the second half's partial scores go to the first half's warps
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xs + (16 * sm + g + 8 * h) * kWideX + 8 * n + 2 * t) =
              make_float2(s[n][2 * h], s[n][2 * h + 1]);
    }
    __syncthreads();  // the partial scores are in
    const int k0 = j * BK;
    const bool masked = k0 + BK > tk || (causal && k0 + BK - 1 > q0);
    if (!hf) {
      // Scale, and mask where the tile crosses the diagonal or the ragged end.
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = *reinterpret_cast<const float2*>(
              xs + (16 * sm + g + 8 * h) * kWideX + 8 * n + 2 * t);
          s[n][2 * h] = (s[n][2 * h] + x.x) * sm_scale;
          s[n][2 * h + 1] = (s[n][2 * h + 1] + x.y) * sm_scale;
          if (masked) {
            const int row = q0 + 16 * sm + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * n + 2 * t + e;
              if (!(col < tk && (!causal || row >= col))) s[n][2 * h + e] = kNegBig;
            }
          }
        }
      // Online softmax on the rows' fragments: p = exp(s - m), taken as
      // exp2((s - m) log2 e); p goes to the p tile as bf16 (the TPU kernel's
      // p.astype(v.dtype)), l sums the unrounded p, and each row's alpha =
      // exp(m_old - m) goes to every warp through shared memory.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * sm + g + 8 * h;
        float mx = m[h];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        const float m_cur = quad_max(mx);
        const float alpha = exp2f((m[h] - m_cur) * kLog2e);  // m = -inf on the first tile -> 0
        const float m_log2 = m_cur * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            // A masked score is exactly kNegBig; it gets p = 0.
            const float x = s[n][e];
            const float p = x == kNegBig && masked ? 0.f : exp2f(fmaf(x, kLog2e, -m_log2));
            s[n][e] = p;
            sum += p;
          }
          *reinterpret_cast<uint32_t*>(ps + r * kWideP + 8 * n + 2 * t) =
              pack_bf16(s[n][2 * h], s[n][2 * h + 1]);
        }
        l[h] = l[h] * alpha + quad_sum(sum);
        m[h] = m_cur;
        if (t == 0) alphas[r] = alpha;
      }
    }
    __syncthreads();  // the p tile and the rows' alpha are in

    // Every warp: its accumulators rescaled by the rows' alpha, then o += p v
    // over its columns: p through ldmatrix, V through ldmatrix.trans.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float alpha = alphas[16 * mt + g + 8 * h];
#pragma unroll
        for (int jn = 0; jn < WC / 8; ++jn) {
          acc[mt][jn][2 * h] *= alpha;
          acc[mt][jn][2 * h + 1] *= alpha;
        }
      }
    if (has_cols) {
      const bf16* vst = vs + (j & 1) * BK * kV;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(a[mt], a_frag(ps, kWideP, 16 * mt, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < WC / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt_pair(vst, kV, kk * 16, wc - c0 + jp * 16, lane));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma(acc[mt][2 * jp], a[mt], b[0], b[1]);
            mma(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }

  // The rows' sums to every warp; lse once a row (column block 0).
  if (!hf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * sm + g + 8 * h;
      if (t == 0) sums[r] = l[h];
      if (t == 0 && blockIdx.z == 0 && q0 + r < tq)
        lse[(size_t)bh * tq + q0 + r] = l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-38f)) : -CUDART_INF_F;
    }
  }
  __syncthreads();
  if (!has_cols) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      if (q0 + r >= tq) continue;
      const float l_row = sums[r];
      const float safe = l_row > 0.f ? l_row : 1.f;
      float* orow = o + ((size_t)bh * tq + q0 + r) * d + wc + 2 * t;
#pragma unroll
      for (int jn = 0; jn < WC / 8; ++jn)
        if (wc + jn * 8 < d)  // the columns past d are zero padding
          *reinterpret_cast<float2*>(orow + jn * 8) =
              make_float2(acc[mt][jn][2 * h] / safe, acc[mt][jn][2 * h + 1] / safe);
    }
}

template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int threads, dim3 grid, const void* q,
                          const void* k, const void* v, float* o, float* lse, int tq, int tk,
                          int d, int causal, float sm_scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), o, lse, tq, tk, d, causal,
                                          sm_scale);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, float* o, float* lse,
                   int bh, int tq, int tk, int d, int causal, float sm_scale,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch_kernel<float>(flash_fwd_f32_kernel<W>, f32_smem_bytes<W>(), kF32Threads,
                                dim3(bh, (tq + kF32BlockQ - 1) / kF32BlockQ), q, k, v, o, lse,
                                tq, tk, d, causal, sm_scale, stream);
  return launch_kernel<bf16>(d == W ? flash_fwd_bf16_kernel<W, true>
                                    : flash_fwd_bf16_kernel<W, false>,
                             bf16_smem_bytes<W>(), kThreads,
                             dim3(bh, (tq + kBlockQ<W> - 1) / kBlockQ<W>), q, k, v, o, lse, tq,
                             tk, d, causal, sm_scale, stream);
}

// The bf16 wide kernel's launch for (bh, tq, d): launch_wide makes it and
// flash_fwd_wide_bf16_shape reports it.
struct WideLaunch {
  decltype(&flash_fwd_wide_bf16_kernel<true>) kernel;
  dim3 grid;
  int threads;
  size_t smem;
};

WideLaunch wide_bf16_launch(int bh, int tq, int d) {
  const bool whole = d <= kWideTileCols;
  return {whole ? flash_fwd_wide_bf16_kernel<true> : flash_fwd_wide_bf16_kernel<false>,
          dim3(bh, (tq + kWideBlockQ - 1) / kWideBlockQ, head_dims::wide_blocks(d, kWideTileCols)),
          kWideThreads, whole ? bf16_wide_smem_bytes<true>() : bf16_wide_smem_bytes<false>()};
}

cudaError_t launch_wide(int dtype, const void* q, const void* k, const void* v, float* o,
                        float* lse, int bh, int tq, int tk, int d, int causal, float sm_scale,
                        cudaStream_t stream) {
  if (dtype == 0)
    return launch_kernel<float>(flash_fwd_wide_f32_kernel, f32_wide_smem_bytes(), kF32Threads,
                                dim3(bh, (tq + kF32BlockQ - 1) / kF32BlockQ,
                                     head_dims::wide_blocks(d, kWideCols)),
                                q, k, v, o, lse, tq, tk, d, causal, sm_scale, stream);
  const WideLaunch l = wide_bf16_launch(bh, tq, d);
  return launch_kernel<bf16>(l.kernel, l.smem, l.threads, l.grid, q, k, v, o, lse, tq, tk, d,
                             causal, sm_scale, stream);
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 = float32 (the FMA kernel),
// 1 = bfloat16 (the tensor-core kernel); d a multiple of 8 (the wide kernels
// past 256).
// The caller has checked shapes, types, contiguity and 16-byte alignment,
// and launches only when bh > 0 and tq > 0.  Returns the launch's CUDA
// error code (0 = none).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int tq, int tk, int d, int dtype, int causal, float sm_scale,
                         void* stream) {
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || !head_dims::takes(d)) return cudaErrorInvalidValue;
  if (head_dims::wide(d))
    return launch_wide(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
  switch (head_dims::tile_width(d)) {
    case 32: return launch<32>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 64: return launch<64>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 96: return launch<96>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 128: return launch<128>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    default: return launch<256>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
  }
}

// The bf16 wide kernel's launch for (bh, tq, d), d past 256, as launch_wide
// makes it, for the logs: out[0..5] = grid x, y, z, threads a block, dynamic
// shared memory bytes and registers a thread (cudaFuncGetAttributes).
// Returns its CUDA error code.
extern "C" int flash_fwd_wide_bf16_shape(int bh, int tq, int d, int* out) {
  if (!head_dims::takes(d) || !head_dims::wide(d)) return cudaErrorInvalidValue;
  const WideLaunch l = wide_bf16_launch(bh, tq, d);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return err;
  const int got[6] = {(int)l.grid.x, (int)l.grid.y, (int)l.grid.z, l.threads, (int)l.smem,
                      attr.numRegs};
  for (int i = 0; i < 6; ++i) out[i] = got[i];
  return cudaSuccess;
}
