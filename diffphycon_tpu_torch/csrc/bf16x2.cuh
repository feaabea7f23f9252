// bf16 rounding and packed bf16x2 arithmetic that reproduce flax's per-op
// bf16 roundings exactly (each op of the plain versions computed in fp32 and
// rounded to bf16, to nearest even), shared by the bf16-activation kernels
// (attention_bf16act.cu, group_norm_act.cu) and the bf16 cores (igemm_tc.cuh
// re-exports bf16x2_rn).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16x2 {

// fp32 rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// the low and the high bf16 of a pair, as fp32 (exact)
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// (lo, hi) rounded to bf16, nearest even, as one bf16x2: lo in the low half
// (the element of the lower k index, as the fragments hold them).
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// bf16(a / b) for a bf16 pair a >= 0 and bf16 values b > 0 (normal
// quotients), given r = __frcp_rn(b) per half: bf16(a r). The quotient of
// two 8-bit significands is never within 2^-17 (relative) of a bf16
// rounding boundary (an odd multiple of 2^-9 of a binade would need 2^8 to
// divide the divisor's significand), and a r is within 2^-22 of the
// quotient, so both round to the same bf16 value; one reciprocal a row (or
// column) replaces a division a value.
__device__ __forceinline__ uint32_t quot2(uint32_t a, float r0, float r1) {
  return bf16x2_rn(__fmul_rn(lo_f(a), r0), __fmul_rn(hi_f(a), r1));
}

// Packed bf16 pairs (the lower index in the low half): a - b, a * b, a + b
// rounded to bf16 once (Hopper's bf16x2 arithmetic). On bf16 operands these
// equal the plain versions' fp32 operation rounded to bf16: a product of two
// 8-bit significands is exact in fp32, and so is a sum or difference unless
// one operand lies far below the other (an exponent gap of 16 or more),
// where both round to the larger one.
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// the bf16 value v (exact in bf16) in both halves
__device__ __forceinline__ uint32_t bpair(float v) { return bf16x2_rn(v, v); }

}  // namespace bf16x2
