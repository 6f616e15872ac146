// Goldilocks field arithmetic for the port's CUDA kernels, p = 2^64 - 2^32 + 1,
// on canonical u64 words (the port's int64 tensors carry the same bits).
// Included by ntt.cu (B2, B3), field.cu (F1, F2, F3) and quotients.cuh (F4,
// and its host harness native/quotients_host.cpp); cuda_build keys a
// library by its source and every header beside it.
//
// A product hi * 2^64 + lo is reduced with 2^64 == 2^32 - 1 and
// 2^96 == -1 (mod p), to the same canonical [0, p) result as ops/field.py
// `reduce128` / `mul`; `gl_sub` is ops/field.py `sub` for any 64-bit words,
// `gl_add` its `add` for canonical ones.
//
// Every function is `__host__ __device__` under nvcc and plain `inline`
// under a host compiler: the device form is PTX, the host form (also the
// one nvcc's host pass sees) is portable C++ with `unsigned __int128`, and
// both give the same bits. So the generated quotient bodies of
// quotients_gen.cuh compile for the card and, with g++, for a CPU test.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define GL_FN __host__ __device__ __forceinline__
#else
#define GL_FN inline
#endif

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ULL;
constexpr uint64_t kM32 = 0xFFFFFFFFULL;  // 2^64 - p == 2^32 - 1

// a - b (mod p) for any 64-bit a and 0 <= b <= p, in [0, 2^64), and in
// [0, p) when a < p: a borrow is repaid with 2^64 - (2^32 - 1) = p. Five
// carry-chained 32-bit instructions; written with `?:` the compiler makes
// eight of it, with a 64-bit compare and two selects.
GL_FN uint64_t gl_sub(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
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
#else
  const uint64_t d = a - b;
  return a < b ? d - kM32 : d;
#endif
}

// a + b = a - (p - b), canonical for canonical a and b (b = 0 borrows and
// is repaid)
GL_FN uint64_t gl_add(uint64_t a, uint64_t b) { return gl_sub(a, kP - b); }

// -a, canonical for canonical a (ops/field.py `neg`)
GL_FN uint64_t gl_neg(uint64_t a) { return gl_sub(0, a); }

// lo + hi * 2^64 (mod p), canonical, for any 128-bit value
GL_FN uint64_t reduce128(uint64_t lo, uint64_t hi) {
  // hi = hh * 2^32 + hl: hh * 2^96 == -hh, and hl * 2^64 == hl * (2^32 - 1)
  // <= (2^32 - 1)^2 < p
  const uint64_t t0 = gl_sub(lo, hi >> 32);
  const uint64_t hl = hi & kM32;
  const uint64_t t1 = (hl << 32) - hl;
  // t0 + t1 - p when that is not negative (then it is below 2^32 + t1 < p),
  // else t0 + t1 < p
  return gl_sub(t0, kP - t1);
}

GL_FN uint64_t gl_mul(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return reduce128(a * b, __umul64hi(a, b));
#else
  const unsigned __int128 w = (unsigned __int128)a * b;
  return reduce128((uint64_t)w, (uint64_t)(w >> 64));
#endif
}

// a^e by square and multiply from the top bit, as ops/field.py
// `pow_const` (e = 0 gives 1; e < 2^63)
GL_FN uint64_t gl_pow(uint64_t a, long long e) {
  if (e <= 0) return 1;
  int bit = 62;
  while (!((e >> bit) & 1)) --bit;
  uint64_t acc = a;
  while (--bit >= 0) {
    acc = gl_mul(acc, acc);
    if ((e >> bit) & 1) acc = gl_mul(acc, a);
  }
  return acc;
}

// F_p^3 = F_p[X] / (X^3 - X + 1): schoolbook, then X^3 = X - 1 and
// X^4 = X^2 - X, in the order of ops/xfield.py `mul_plain`
GL_FN void xf_mul(uint64_t a0, uint64_t a1, uint64_t a2, uint64_t b0,
                  uint64_t b1, uint64_t b2, uint64_t& r0, uint64_t& r1,
                  uint64_t& r2) {
  const uint64_t c0 = gl_mul(a0, b0);
  const uint64_t c1 = gl_add(gl_mul(a0, b1), gl_mul(a1, b0));
  const uint64_t c2 =
      gl_add(gl_add(gl_mul(a0, b2), gl_mul(a1, b1)), gl_mul(a2, b0));
  const uint64_t c3 = gl_add(gl_mul(a1, b2), gl_mul(a2, b1));
  const uint64_t c4 = gl_mul(a2, b2);
  r0 = gl_sub(c0, c3);
  r1 = gl_sub(gl_add(c1, c3), c4);
  r2 = gl_add(c2, c4);
}

// An F_p^3 element c0 + c1 X + c2 X^2, canonical coefficients, and the
// operations of the quotient bodies on it. A base operand b of a mixed
// operation is the element (b, 0, 0), as ops/xfield.py `from_base` lifts
// it; its zero coefficients are left out where that changes no bit.
struct Xf {
  uint64_t c0, c1, c2;
};

GL_FN Xf xf_add(const Xf& a, const Xf& b) {
  return Xf{gl_add(a.c0, b.c0), gl_add(a.c1, b.c1), gl_add(a.c2, b.c2)};
}

GL_FN Xf xf_sub(const Xf& a, const Xf& b) {
  return Xf{gl_sub(a.c0, b.c0), gl_sub(a.c1, b.c1), gl_sub(a.c2, b.c2)};
}

GL_FN Xf xf_neg(const Xf& a) {
  return Xf{gl_neg(a.c0), gl_neg(a.c1), gl_neg(a.c2)};
}

// a + (b, 0, 0)
GL_FN Xf xf_add_base(const Xf& a, uint64_t b) {
  return Xf{gl_add(a.c0, b), a.c1, a.c2};
}

// a - (b, 0, 0)
GL_FN Xf xf_sub_base(const Xf& a, uint64_t b) {
  return Xf{gl_sub(a.c0, b), a.c1, a.c2};
}

// (a, 0, 0) - b
GL_FN Xf xf_base_sub(uint64_t a, const Xf& b) {
  return Xf{gl_sub(a, b.c0), gl_neg(b.c1), gl_neg(b.c2)};
}

GL_FN Xf xf_mul(const Xf& a, const Xf& b) {
  Xf r;
  xf_mul(a.c0, a.c1, a.c2, b.c0, b.c1, b.c2, r.c0, r.c1, r.c2);
  return r;
}

// a (b, 0, 0)
GL_FN Xf xf_mul_base(const Xf& a, uint64_t b) {
  return Xf{gl_mul(a.c0, b), gl_mul(a.c1, b), gl_mul(a.c2, b)};
}

// a^e as ops/xfield.py `pow_const` (e = 0 gives 1)
GL_FN Xf xf_pow(const Xf& a, long long e) {
  if (e <= 0) return Xf{1, 0, 0};
  int bit = 62;
  while (!((e >> bit) & 1)) --bit;
  Xf acc = a;
  while (--bit >= 0) {
    acc = xf_mul(acc, acc);
    if ((e >> bit) & 1) acc = xf_mul(acc, a);
  }
  return acc;
}

}  // namespace
