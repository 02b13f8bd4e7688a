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
// or 201.9 us, against 172.0 GFLOP (four products) or 173.9 us: bytes.
//
// Design.  The TPU runs each pass as a grid whose innermost axis is
// sequential and carries the accumulator in VMEM scratch; Hopper blocks run
// in no order, so that axis becomes a loop inside one thread block, and the
// accumulators stay in registers.  Neither pass needs atomics, and both are
// deterministic:
//   dq pass:   one block per (bh, 64-row q tile).  It walks the 64-row k/v
//              tiles up to the diagonal and keeps its dq rows in registers.
//   dk/dv pass: one block per (bh, 64-row k tile).  It walks the q/do tiles
//              from the diagonal on and keeps its dk and dv rows in
//              registers.
// Each of the 8 warps owns 8 rows of the block's tile; a lane holds two
// columns of the 64 x 64 score tile for each (so s and do v^T are computed
// once per pass, from shared memory), writes its p / ds values to a shared
// tile, and then owns d / 32 output columns of each of its rows for the
// products that follow.  Tiles are staged in shared memory as float32;
// tiles read one row per lane are padded by one word so the 32 lanes hit
// 32 banks.  The products are plain float32 FMAs, as in flash_fwd.cu: this
// first kernel is simple and right, and is bound by its own instruction
// rate far above the byte floor.  Tensor-core products, TMA loads and a
// software pipeline are the later work that closes that gap.  The ragged
// tail (T not a multiple of 64) is masked in the kernel: out-of-range rows
// load as zeros with lse = -inf, so they add nothing, and are never
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;  // q rows per tile
constexpr int kBlockK = 64;  // k rows per tile (the causal loop bounds rely on kBlockQ == kBlockK)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 64 / kWarps;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x.astype(dtype of the pointer) before a product: a no-op for float32, a
// rounding for bf16.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int tq, int tk, int causal, float sm_scale) {
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
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const bool in = q0 + i / D < tq;
    qs[i] = in ? to_float(q[qoff + i]) : 0.f;
    dos[i] = in ? to_float(dout[qoff + i]) : 0.f;
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
      ks[r * (D + 1) + c] = in ? to_float(kb[(size_t)k0 * D + i]) : 0.f;
      vs[r * (D + 1) + c] = in ? to_float(vb[(size_t)k0 * D + i]) : 0.f;
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
        const float ds = p * (dp[r][j] - row_delta) * sm_scale;
        dss[(row0 + r) * kBlockK + lane + 32 * j] = round_as(ds, k);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, int causal, float sm_scale) {
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
  const T* qb = q + (size_t)bh * tq * D;
  const T* dob = dout + (size_t)bh * tq * D;

  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const bool in = k0 + i / D < tk;
    ks[i] = in ? to_float(k[koff + i]) : 0.f;
    vs[i] = in ? to_float(v[koff + i]) : 0.f;
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
      qs[r * (D + 1) + c] = in ? to_float(qb[(size_t)q0 * D + i]) : 0.f;
      dos[r * (D + 1) + c] = in ? to_float(dob[(size_t)q0 * D + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool in = q0 + i < tq;
      lses[i] = in ? lse[(size_t)bh * tq + q0 + i] : -CUDART_INF_F;
      deltas[i] = in ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's k rows; the lane owns q
    // columns lane and lane + 32.  Same products in the same order as the
    // dq pass, so both passes see bitwise the same s and p.
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
        const float ds = p * (dp[r][j] - deltas[qj]) * sm_scale;
        ps[(row0 + r) * kBlockQ + qj] = round_as(p, dout);
        dss[(row0 + r) * kBlockQ + qj] = round_as(ds, q);
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, int bh, int tq, int tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq, tq, tk, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int tq, int tk, int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk, dv, tq, tk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The caller has checked shapes, types and contiguity, launches the dq pass
// only when bh > 0 and tq > 0 and the dk/dv pass only when bh > 0 and
// tk > 0.  Each returns its launch's CUDA error code (0 = none).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, int causal, float sm_scale,
                            void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* o = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_dq<float, 64>(q, k, v, dout, l, dl, o, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 0 && d == 128)
    return launch_dq<float, 128>(q, k, v, dout, l, dl, o, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 1 && d == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, o, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 1 && d == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, o, bh, tq, tk, causal, sm_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_dkv<float, 64>(q, k, v, dout, l, dl, gk, gv, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 0 && d == 128)
    return launch_dkv<float, 128>(q, k, v, dout, l, dl, gk, gv, bh, tq, tk, causal, sm_scale, s);
  if (dtype == 1 && d == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, gk, gv, bh, tq, tk, causal,
                                         sm_scale, s);
  if (dtype == 1 && d == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, gk, gv, bh, tq, tk, causal,
                                          sm_scale, s);
  return cudaErrorInvalidValue;
}
