// Causal / non-causal flash attention forward for one block: Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of polyaxon_tpu/parallel/flash.py
// (called there through `flash_block_fwd`).  Same function:
//   o   = softmax(q k^T * sm_scale [causal mask]) v, normalised, float32
//   lse = log-sum-exp of the masked, scaled scores, float32, [BH, Tq]
// with q [BH, Tq, d], k/v [BH, Tk, d] (bf16 or f32, contiguous), d in {64,128}.
// Causal masking assumes q and k share one global offset (the diagonal
// block), masks with -1e30 and skips key tiles wholly above the diagonal.
// A row with no visible key gets lse = -inf and o = 0.  p is rounded to the
// input type before P.V, as the TPU kernel rounds it to v's dtype; all sums
// are float32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at
// the prefill shape of the 671M model (BH = 4 x 32, T = 512, d = 64, bf16,
// causal): it reads 3 x 8.4 MB of q/k/v and writes 16.8 MB of o plus 0.26 MB
// of lse, 42.2 MB, which takes 12.6 us at 3.35 TB/s; the causal half of the
// two products is 4.3 GFLOP, 4.4 us at 989 TFLOP/s.  The call is bound by
// bytes, so the least it can take is about 12.6 us.
//
// Design.  The TPU's sequential key-block grid axis becomes a loop inside
// one thread block: block (bh, q-tile) owns 64 query rows and walks the
// 64-row key tiles up to the diagonal, holding the running max m, the
// running sum l and the output accumulator in registers, so the [T, T]
// scores never reach device memory and each q/k/v row is read from HBM once
// per q-tile that needs it (the byte bound above).  Each of the 8 warps owns
// 8 query rows; a lane holds two score columns of each, so the row max and
// row sum are warp shuffles.  Tiles are staged in shared memory as float32
// (key rows padded by one word so the 32 lanes read 32 banks).  The products
// are plain float32 FMAs: this first kernel is simple and right, and is
// bound by its own instruction rate far above the 12.6 us floor.  Tensor-core
// products (mma.sync / wgmma), TMA loads and a software pipeline are the
// later work that closes that gap.  The ragged tail (T not a multiple of 64)
// is masked in the kernel: out-of-range key columns never enter m or l, and
// out-of-range query rows are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;               // query rows per thread block
constexpr int kBlockK = 64;               // key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kNegBig = -1e30f;         // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// p.astype(v.dtype) before P.V: a no-op for float32, a rounding for bf16.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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

template <int D>
constexpr size_t smem_bytes() {
  // q tile [BQ][D], k tile [BK][D+1], v tile [BK][D], p tile [BQ][BK]
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kBlockK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse,
                 int tq, int tk, int causal, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * (D + 1);
  float* ps = vs + kBlockK * D;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = (q0 + r < tq) ? to_float(qb[(size_t)q0 * D + i]) : 0.f;
  }

  constexpr int kCols = D / 32;  // output columns per lane
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // Causal: key tiles that start past this q-tile's last row are all masked.
  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and the q tile is stored)
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < tk;
      ks[r * (D + 1) + c] = in ? to_float(kb[(size_t)k0 * D + i]) : 0.f;
      vs[i] = in ? to_float(vb[(size_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

    // s = q k^T for this warp's rows; the lane owns key columns lane, lane+32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float k_lo = ks[lane * (D + 1) + c];
      const float k_hi = ks[(lane + 32) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qs[(row0 + r) * D + c];
        s[r][0] = fmaf(qv, k_lo, s[r][0]);
        s[r][1] = fmaf(qv, k_hi, s[r][1]);
      }
    }

    // Online softmax, one row at a time (the whole warp shares a row).
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
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
      for (int j = 0; j < 2; ++j)
        ps[(row0 + r) * kBlockK + lane + 32 * j] = round_as(p[j], q);
    }
    __syncwarp();  // a warp reads back only the p rows it wrote

    // acc += p v; the lane owns output columns lane + 32 c.
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pv = ps[(row0 + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pv, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= tq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    float* orow = o + ((size_t)bh * tq + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[lane + 32 * c] = acc[r][c] / safe;
    if (lane == 0)
      lse[(size_t)bh * tq + row] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-38f)) : -CUDART_INF_F;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* o, float* lse,
                   int bh, int tq, int tk, int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), o, lse, tq, tk, causal,
                                           sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The caller has checked shapes, types and contiguity, and launches only
// when bh > 0 and tq > 0.  Returns the launch's CUDA error code (0 = none).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int tq, int tk, int d, int dtype, int causal, float sm_scale,
                         void* stream) {
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, of, lf, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, of, lf, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, k, v, of, lf, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, k, v, of, lf, bh, tq, tk, causal, sm_scale, s);
  return cudaErrorInvalidValue;
}
