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

template <typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int threads, int block_q, const void* q,
                          const void* k, const void* v, float* o, float* lse, int bh, int tq,
                          int tk, int d, int causal, float sm_scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + block_q - 1) / block_q);
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
                                kF32BlockQ, q, k, v, o, lse, bh, tq, tk, d, causal, sm_scale,
                                stream);
  return launch_kernel<bf16>(d == W ? flash_fwd_bf16_kernel<W, true>
                                    : flash_fwd_bf16_kernel<W, false>,
                             bf16_smem_bytes<W>(), kThreads, kBlockQ<W>, q, k, v, o, lse, bh, tq,
                             tk, d, causal, sm_scale, stream);
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 = float32 (the FMA kernel),
// 1 = bfloat16 (the tensor-core kernel); d a multiple of 8 from 8 to 256.
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
  switch (head_dims::tile_width(d)) {
    case 32: return launch<32>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 64: return launch<64>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 96: return launch<96>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    case 128: return launch<128>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
    default: return launch<256>(dtype, q, k, v, of, lf, bh, tq, tk, d, causal, sm_scale, s);
  }
}
