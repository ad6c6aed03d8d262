// Helpers of the SSD scan's mma.sync kernels, csrc/ssd_scan_mma.cu (whole
// chunks staged at once) and csrc/ssd_scan_stream.cu (chunks streamed in
// sub-tiles): shared-row padding, fragment loads, bf16 products and the
// splits of an f32 operand into parts the tensor core multiplies exactly.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int RT = 32;  // rows of a row tile
constexpr int SMEM_LIMIT = 232448;

// 32-bit words of a shared row of n elements of e bytes, padded so that the
// count is rem modulo mod
__host__ __device__ constexpr int row_words(int n, int e, int rem, int mod) {
  return n * e / 4 + ((rem - n * e / 4) % mod + mod) % mod;
}
// a C, B or x row of n (padded) elements in the input type: f32 rows 8
// words mod 32 (8-byte pairs read from 8 rows), bf16 rows 4 mod 32
// (ldmatrix: 16 bytes from each of 8 rows)
__host__ __device__ constexpr int in_words(int n, int itemsize) {
  return itemsize == 4 ? row_words(n, 4, 8, 32) : row_words(n, 2, 4, 32);
}
// a row of P (f32, 8-byte pairs read from 8 rows) over lp columns
__host__ __device__ constexpr int p_words(int lp) { return row_words(lp, 4, 8, 32); }
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__device__ __forceinline__ float2 ld2(const void* p) { return *reinterpret_cast<const float2*>(p); }

// four 8 x 8 bf16 matrices, lanes 8m .. 8m + 7 giving the rows of matrix m:
// lane t gets (row t / 4, columns 2 (t % 4), + 1) of each, or with .trans
// (rows 2 (t % 4), + 1, column t / 4), the lower index in the low half
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
// c += a * b on one m16n8k16 bf16 tile, in f32: the product of two bf16
// values is exact in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a word's two bf16 values (the lower index in the low half) as f32
__device__ __forceinline__ float2 bf16x2_unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// (x, y) = hi + mid + lo, each part a pair of bf16 (x in the low half),
// returned as p[0] = lo, p[1] = mid, p[2] = hi, the order they are
// multiplied in: each subtraction is exact, and what is left is below
// 2^-24 of |x| and |y|
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hi);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(mid);
  p[0] = bf16x2_bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
  p[1] = bf16x2_bits(mid);
  p[2] = bf16x2_bits(hi);
}

// the parts of four pairs as the A fragments of the three parts
__device__ __forceinline__ void split3_frag(const float2 (&v)[4], uint32_t (&a)[3][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t t[3];
    split3(v[e].x, v[e].y, t);
#pragma unroll
    for (int q = 0; q < 3; ++q) a[q][e] = t[q];
  }
}

// c += a * b, both given as their parts: three products, small terms first
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&a_big)[4],
                                          const uint32_t (&a_small)[4], uint32_t b0_big,
                                          uint32_t b1_big, uint32_t b0_small,
                                          uint32_t b1_small) {
  mma(c, a_small, b0_big, b1_big);
  mma(c, a_big, b0_small, b1_small);
  mma(c, a_big, b0_big, b1_big);
}

// the A fragment of rows gid (pair p0) and gid + 8 (pair p1), physical
// columns 2 tig and 2 tig + 1, split into its parts
__device__ __forceinline__ void split_pairs(float2 p0, float2 p1, uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  split(p0.x, big[0], small[0]);
  split(p1.x, big[1], small[1]);
  split(p0.y, big[2], small[2]);
  split(p1.y, big[3], small[3]);
}

}  // namespace
