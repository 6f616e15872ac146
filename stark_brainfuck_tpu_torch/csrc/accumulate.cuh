// The weighted lazy accumulation of the combination, shared by kernel F3
// (field.cu `acc_group_kernel`), kernel F4 (quotients.cu, through
// quotients.cuh) and F4's host harness (native/quotients_host.cpp):
//
//   acc[i] += sum_t (w_plain_t + w_shift_t * start_t * ratio_t^i) * y_t[i]
//
// Power tables. A term's x^s factor start * ratio^i comes from a row of
// tables, r^j (j < kAccTile), r^(kAccTile m) (m < kAccMid) and start *
// r^(2^kAccLogTop h) (h < top), for i = (kAccMid h + m) kAccTile + j. A
// block whose positions start at tile0 makes w_shift * start * r^tile0
// once a term (`term_start`: two table words, four multiplies), and
// position tile0 + j reads r^(tile0 mod kAccTile + j), one table word.
//
// Lazy sums. Each position's 128-bit products (6 a base term, 9 an
// extension term, which multiplies the coefficient c by y's 3 x 3
// multiplication matrix, X^3 = X - 1 folded into y's entries) are summed
// unreduced, one sum per coefficient of the result, and reduced once at the
// end with 2^128 == -2^32 (mod p). A sum keeps the even and the odd 32 x 32
// partial products apart (Sum160), so that on the card each multiply-add
// lands on a 64-bit register pair: a product and its add are 4 wide
// multiply-adds and 3 carry adds. The host form of `mac` computes the same
// five words with `unsigned __int128`.
//
// Field sums are exact, so neither the order of the terms nor the lazy
// sums change a bit of the result.

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace {

// the power tables' split of a position i = (kAccMid h + m) kAccTile + j
constexpr int kAccLogTile = 8;
constexpr int kAccTile = 1 << kAccLogTile;
constexpr int kAccLogMid = 6;
constexpr int kAccMid = 1 << kAccLogMid;
constexpr int kAccLogTop = kAccLogTile + kAccLogMid;

// an unreduced sum of 128-bit products a b (a = a0 + a1 2^32, b likewise),
// kept by the weight of their 32 x 32 partial products so that every
// multiply-add lands on a 64-bit register pair: the even sum e0 + e1 2^64
// + e2 2^128 of a0 b0 + a1 b1 2^64, the odd sum o + o2 2^64 of a0 b1 +
// a1 b0; the sum is even + odd 2^32
struct Sum160 {
  uint64_t e0, e1, o;
  uint32_t e2, o2;
};

// s += a * b: on the card four multiply-adds of 32 x 32 words into 64-bit
// pairs, each with its carry out (the compiler makes each low and high
// pair one wide multiply-add), and three carry adds
GL_FN void mac(Sum160& s, uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, x0, x1, x2, x3, y0, y1;\n\t"
      "mov.b64 {a0, a1}, %5;\n\t"
      "mov.b64 {b0, b1}, %6;\n\t"
      "mov.b64 {x0, x1}, %0;\n\t"
      "mov.b64 {x2, x3}, %1;\n\t"
      "mov.b64 {y0, y1}, %3;\n\t"
      "mad.lo.cc.u32 x0, a0, b0, x0;\n\t"
      "madc.hi.cc.u32 x1, a0, b0, x1;\n\t"
      "madc.lo.cc.u32 x2, a1, b1, x2;\n\t"
      "madc.hi.cc.u32 x3, a1, b1, x3;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "mad.lo.cc.u32 y0, a0, b1, y0;\n\t"
      "madc.hi.cc.u32 y1, a0, b1, y1;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 y0, a1, b0, y0;\n\t"
      "madc.hi.cc.u32 y1, a1, b0, y1;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mov.b64 %0, {x0, x1};\n\t"
      "mov.b64 %1, {x2, x3};\n\t"
      "mov.b64 %3, {y0, y1};\n\t"
      "}"
      : "+l"(s.e0), "+l"(s.e1), "+r"(s.e2), "+l"(s.o), "+r"(s.o2)
      : "l"(a), "l"(b));
#else
  const uint64_t a0 = a & kM32, a1 = a >> 32, b0 = b & kM32, b1 = b >> 32;
  const unsigned __int128 even = ((unsigned __int128)s.e1 << 64) | s.e0;
  const unsigned __int128 sum =
      even + (((unsigned __int128)(a1 * b1) << 64) | (a0 * b0));
  s.e2 += sum < even;
  s.e0 = (uint64_t)sum;
  s.e1 = (uint64_t)(sum >> 64);
  const uint64_t odd0 = a0 * b1, odd1 = a1 * b0;
  s.o += odd0;
  s.o2 += s.o < odd0;
  s.o += odd1;
  s.o2 += s.o < odd1;
#endif
}

// s (mod p), canonical: the even sum with 2^128 == -2^32 (e2 2^32 < p
// while e2 < 2^32 - 1), the odd one times 2^32 as o 2^32 + o2 2^96 with
// 2^96 == -1 (o2 < p); F3 and F4 sum at most 192 products a sum, so e2
// and o2 stay below 2^9
GL_FN uint64_t reduce160(const Sum160& s) {
  const uint64_t even =
      gl_sub(reduce128(s.e0, s.e1), (uint64_t)s.e2 << 32);
  const uint64_t odd = gl_sub(reduce128(s.o << 32, s.o >> 32), s.o2);
  return gl_add(even, odd);
}

// a term's six words at a block's first position tile0 from its table row
// and its weights w (w_plain, w_shift: 2 x 3 words): w_shift * start *
// r^tile0, then w_plain
GL_FN void term_start(const uint64_t* row, long long tile0,
                      const uint64_t* w, uint64_t* out) {
  const long long h = tile0 >> kAccLogTop;
  const int m = (int)(tile0 >> kAccLogTile) & (kAccMid - 1);
  const uint64_t x0 = gl_mul(row[kAccTile + kAccMid + h], row[kAccTile + m]);
  for (int k = 0; k < 3; ++k) {
    out[k] = gl_mul(w[3 + k], x0);
    out[3 + k] = w[k];
  }
}

// s += (w[0..2] x + w[3..5]) (y0, y1, y2), the term's `term_start` words w
// and its position's table word x
GL_FN void acc_ext_term(Sum160* s, const uint64_t* w, uint64_t x,
                        uint64_t y0, uint64_t y1, uint64_t y2) {
  const uint64_t c0 = gl_add(gl_mul(w[0], x), w[3]);
  const uint64_t c1 = gl_add(gl_mul(w[1], x), w[4]);
  const uint64_t c2 = gl_add(gl_mul(w[2], x), w[5]);
  // c * y with X^3 = X - 1 as y's multiplication matrix times c: r0 = c0
  // y0 - c1 y2 - c2 y1, r1 = c0 y1 + c1 (y0 + y2) + c2 (y1 - y2), r2 = c0
  // y2 + c1 y1 + c2 (y0 + y2); p - y is p for y = 0, whose products are 0
  // (mod p) all the same
  const uint64_t u = gl_add(y0, y2);
  mac(s[0], c0, y0);
  mac(s[0], c1, kP - y2);
  mac(s[0], c2, kP - y1);
  mac(s[1], c0, y1);
  mac(s[1], c1, u);
  mac(s[1], c2, gl_sub(y1, y2));
  mac(s[2], c0, y2);
  mac(s[2], c1, y1);
  mac(s[2], c2, u);
}

// s += (w[0..2] x + w[3..5]) y for a base word y, as (w[0..2]) (x y) +
// w[3..5] y: one reduced multiply and six products, where the coefficient
// would take three multiplies and three adds
GL_FN void acc_base_term(Sum160* s, const uint64_t* w, uint64_t x,
                         uint64_t y) {
  const uint64_t z = gl_mul(x, y);
  mac(s[0], w[0], z);
  mac(s[0], w[3], y);
  mac(s[1], w[1], z);
  mac(s[1], w[4], y);
  mac(s[2], w[2], z);
  mac(s[2], w[5], y);
}

#ifdef __CUDACC__

// a[k] = a[0] * q^k for k < len, a[0] set: rounds of a[s + j] = a[j] *
// q^s for j < s, s = 1, 2, 4, ...; q becomes q^(2^ceil(log2 len)). Every
// thread of the block calls it.
__device__ void fill_powers(uint64_t* a, long long len, uint64_t& q) {
  for (long long s = 1; s < len; s <<= 1) {
    __syncthreads();
    const long long m = len - s < s ? len - s : s;
    for (long long j = threadIdx.x; j < m; j += blockDim.x)
      a[s + j] = gl_mul(a[j], q);
    q = gl_mul(q, q);
  }
}

// one row of power tables for `ratio` and `start`, `top` entries in its
// last part, by the whole block: r^j (j < kAccTile), then r^(kAccTile m)
// (m < kAccMid), then start * r^(2^kAccLogTop h) (h < top)
__device__ void power_row(uint64_t ratio, uint64_t start, uint64_t* row,
                          long long top) {
  uint64_t* mid = row + kAccTile;
  uint64_t* hi = mid + kAccMid;
  if (threadIdx.x == 0) {
    row[0] = 1;
    mid[0] = 1;
    hi[0] = start;
  }
  uint64_t q = ratio;
  fill_powers(row, kAccTile, q);  // q = r^kAccTile after
  fill_powers(mid, kAccMid, q);   // q = r^(2^kAccLogTop) after
  fill_powers(hi, top, q);
}

#endif  // __CUDACC__

}  // namespace
