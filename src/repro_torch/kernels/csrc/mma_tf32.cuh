// Split-TF32 products on Hopper's tensor cores, and cp.async.
//
// Both mma.sync kernels include this: csrc/flash_attention.cu and
// csrc/ssd_scan_mma.cu. An f32 operand x is split into big = tf32(x)
// (cvt.rna.tf32.f32) and small = x - big, which the tensor core reads
// truncated to TF32; a * b is taken as small_a * big_b + big_a * small_b +
// big_a * big_b, small terms first, on mma.sync.m16n8k8 TF32 (the dropped
// small * small term and the truncation of small are below 2^-21 of the
// product). An operand exact in TF32 (any bf16 value) has no small part,
// and its terms drop.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small: big rounded to TF32, small the rest in f32, which the
// tensor core reads truncated to TF32; what is lost is below 2^-21 of |x|
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b with a given as its parts and b as one pair of f32 values:
// three products, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split(b0, b0_big, b0_small);
  split(b1, b1_big, b1_small);
  mma(c, a_small, b0_big, b1_big);
  mma(c, a_big, b0_small, b1_small);
  mma(c, a_big, b0_big, b1_big);
}

// the same with b exact in TF32 (bf16 bits in the top half): two products
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], uint32_t b0, uint32_t b1) {
  mma(c, a_small, b0, b1);
  mma(c, a_big, b0, b1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
