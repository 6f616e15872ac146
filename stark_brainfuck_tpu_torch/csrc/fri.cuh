// The body of FRI's fold, for kernel F5 (fri.cu) on the card and for the
// host tail's fold (native/fri_host.cpp) under g++: one fold round maps a
// codeword cw of N F_p^3 values to the N/2 values
//
//   new[i] = 2^-1 · ((cw[i] + cw[i+N/2]) + α · x_i^-1 · (cw[i] - cw[i+N/2]))
//
// for i < N/2, where x_i^-1 = s · r^i, s the start seed and r = ω^-1. This
// is the function of ops/fri_kernels.py `fold_math`, the JAX package's
// `_fold_math` (ref fri.py:127-128): (1 + a)·lo + (1 - a)·hi equals
// (lo + hi) + a·(lo - hi) in F_p^3, and every operation gives the
// canonical word, so the bits are the same with one F_p^3 multiply where
// the plain form has two.
//
// The body takes s and r, not a table of x_i^-1: s is offset^-1 on one
// device and offset^-1 · ω^-(rank·N/2) on a mesh rank, so one body serves
// both. r^i comes from the ladder r^(2^k) (k < kFoldLadder), which the
// caller computes on the host and passes by value with s, α and 2^-1
// (`FriFold`, laid out in kFoldWords words by ops/fri_kernels.py
// `fold_words`).

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace {

// r^(2^k) for k < kFoldLadder: every index below 2^32
constexpr int kFoldLadder = 32;
// words of a fold's constants: α (3), 2^-1, s, then the ladder
constexpr int kFoldWords = 5 + kFoldLadder;

struct FriFold {
  Xf alpha;
  uint64_t two_inv;
  uint64_t start;
  uint64_t ladder[kFoldLadder];
};

GL_FN FriFold fri_fold_args(const unsigned long long* w) {
  FriFold F;
  F.alpha = Xf{w[0], w[1], w[2]};
  F.two_inv = w[3];
  F.start = w[4];
  for (int k = 0; k < kFoldLadder; ++k) F.ladder[k] = w[5 + k];
  return F;
}

// x · r^e by the ladder: one multiply a set bit of e
GL_FN uint64_t fri_step(const FriFold& F, uint64_t x, unsigned long long e) {
  for (int k = 0; e; ++k, e >>= 1)
    if (e & 1) x = gl_mul(x, F.ladder[k]);
  return x;
}

// the folded value of the pair (lo, hi) = (cw[i], cw[i+N/2]) at
// inv_x = x_i^-1
GL_FN Xf fri_fold_at(const FriFold& F, uint64_t inv_x, const Xf& lo,
                     const Xf& hi) {
  const Xf a = xf_mul_base(F.alpha, inv_x);
  const Xf t = xf_add(xf_add(lo, hi), xf_mul(a, xf_sub(lo, hi)));
  return xf_mul_base(t, F.two_inv);
}

GL_FN Xf fri_load(const uint64_t* cw, long long i) {
  return Xf{cw[3 * i], cw[3 * i + 1], cw[3 * i + 2]};
}

GL_FN void fri_store(uint64_t* out, long long i, const Xf& v) {
  out[3 * i] = v.c0;
  out[3 * i + 1] = v.c1;
  out[3 * i + 2] = v.c2;
}

}  // namespace
