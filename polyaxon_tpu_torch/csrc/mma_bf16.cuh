// PTX helpers for the tensor-core (bf16) flash kernels: Hopper (sm_90a).
//
// cp.async copies into shared memory (16 bytes, or 4 for float rows whose
// addresses need not be 16-byte aligned), with the src-size form that
// writes zeros for rows past the end; ldmatrix to feed mma.sync fragments;
// mma.sync m16n8k16 with bf16 operands and float32 accumulators.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16, row-major, 4 registers of two bf16 each:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16 x 8 (k x n), column-major, 2 registers:
//     b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16 x 8 float32, 4 registers:
//     c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// So an accumulator tile of two neighbouring 8-column blocks converts in
// registers into the A fragment of a product over those 16 columns
// (pack_bf16), which is how p and ds reach their second product without
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes a zero word.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives, of each matrix, row g, columns 2t and 2t + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, transposed: lane receives rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b, one m16n8k16 product, bf16 in, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 (round to nearest even, as
// x.astype(bfloat16)), lo in the low half: one register of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16-column product from two neighbouring 8-column
// accumulator blocks c (columns 0-7) and d (columns 8-15).
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&c)[4],
                                           const float (&d)[4]) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(d[0], d[1]);
  a[3] = pack_bf16(d[2], d[3]);
}

// Address (for ldmatrix_x4) of this lane's row in a 16 x 16 bf16 block at
// (r0, c0) of a shared tile with row stride `stride` elements, for:
//   a_frag:  the A fragment of rows r0.., k columns c0.. (a0..a3 in order);
//   b_pair:  two B fragments of a tile stored [n][k] (n rows r0.., k c0..):
//            r[0], r[1] for n r0..r0+7, r[2], r[3] for n r0+8..;
//   bt_pair: with ldmatrix_x4_trans, two B fragments of a tile stored
//            [k][n] (k rows r0.., n columns c0..): r[0], r[1] for n
//            c0..c0+7, r[2], r[3] for n c0+8...
__device__ __forceinline__ const __nv_bfloat16* a_frag(const __nv_bfloat16* s, int stride, int r0,
                                                       int c0, int lane) {
  const int mi = lane / 8;
  return s + (r0 + lane % 8 + (mi & 1) * 8) * stride + c0 + (mi >> 1) * 8;
}

__device__ __forceinline__ const __nv_bfloat16* b_pair(const __nv_bfloat16* s, int stride, int r0,
                                                       int c0, int lane) {
  const int mi = lane / 8;
  return s + (r0 + lane % 8 + (mi >> 1) * 8) * stride + c0 + (mi & 1) * 8;
}

__device__ __forceinline__ const __nv_bfloat16* bt_pair(const __nv_bfloat16* s, int stride,
                                                        int r0, int c0, int lane) {
  return a_frag(s, stride, r0, c0, lane);  // the same addresses, read transposed
}

// Stage rows [r0, r0 + ROWS) of a [t, D] bf16 matrix into a shared tile of
// row stride D + 8 (the 16-byte pad puts the 8 rows of an ldmatrix on 8
// different bank quads); rows at or past t arrive as zeros.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, const __nv_bfloat16* g, int r0,
                                          int t) {
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  constexpr int kPerThread = (ROWS * kChunks + THREADS - 1) / THREADS;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (ROWS * kChunks % THREADS != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r0 + r < t;
    cp_async16(s + r * (D + 8) + c, in ? g + (size_t)(r0 + r) * D + c : g, in ? 16 : 0);
  }
}

}  // namespace mma_bf16
