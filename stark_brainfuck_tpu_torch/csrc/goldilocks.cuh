// Goldilocks field arithmetic for the port's CUDA kernels, p = 2^64 - 2^32 + 1,
// on canonical u64 words (the port's int64 tensors carry the same bits).
// Included by ntt.cu (B2, B3) and field.cu (F1, F2, F3); cuda_build keys a
// library by its source and every header beside it.
//
// A product hi * 2^64 + lo is reduced with 2^64 == 2^32 - 1 and
// 2^96 == -1 (mod p), to the same canonical [0, p) result as ops/field.py
// `reduce128` / `mul`; `gl_sub` is ops/field.py `sub` for any 64-bit words,
// `gl_add` its `add` for canonical ones.

#pragma once

#include <cstdint>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ULL;
constexpr uint64_t kM32 = 0xFFFFFFFFULL;  // 2^64 - p == 2^32 - 1

// a - b (mod p) for any 64-bit a and 0 <= b <= p, in [0, 2^64), and in
// [0, p) when a < p: a borrow is repaid with 2^64 - (2^32 - 1) = p. Five
// carry-chained 32-bit instructions; written with `?:` the compiler makes
// eight of it, with a 64-bit compare and two selects.
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d;
  asm("{\n\t"
      ".reg .u32 borrow;\n\t"
      ".reg .u64 fix;\n\t"
      "sub.cc.u64 %0, %1, %2;\n\t"
      "subc.u32 borrow, 0, 0;\n\t"  // 0, or 2^32 - 1 after a borrow
      "cvt.u64.u32 fix, borrow;\n\t"
      "sub.u64 %0, %0, fix;\n\t"
      "}"
      : "=l"(d)
      : "l"(a), "l"(b));
  return d;
}

// a + b = a - (p - b), canonical for canonical a and b (b = 0 borrows and
// is repaid)
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  return gl_sub(a, kP - b);
}

// lo + hi * 2^64 (mod p), canonical, for any 128-bit value
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  // hi = hh * 2^32 + hl: hh * 2^96 == -hh, and hl * 2^64 == hl * (2^32 - 1)
  // <= (2^32 - 1)^2 < p
  const uint64_t t0 = gl_sub(lo, hi >> 32);
  const uint64_t hl = hi & kM32;
  const uint64_t t1 = (hl << 32) - hl;
  // t0 + t1 - p when that is not negative (then it is below 2^32 + t1 < p),
  // else t0 + t1 < p
  return gl_sub(t0, kP - t1);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace
