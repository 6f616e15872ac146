// Kernel F4's arguments and row access, shared by the kernel
// (quotients.cu) and its host harness (native/quotients_host.cpp): one
// table's boundary, transition and terminal quotients at position i, the
// body generated from the models into quotients_gen.cuh.
//
// A column is (address, position stride, coefficient stride) in words, read
// where it lies: the LDE's column views, a zero-stride view of one zero
// word for an empty table, a 0-dim zerofier inverse (position stride 0).
// The next row of column c is its `nxt` column at position (i + rot) mod n:
// the same column with rot = the row shift (resident: the unit distance;
// a streamed class: unit distance / B), or columns the caller rolled
// itself (a mesh) with rot = 0. Output t at position i is written to
// out[(t n + i) 3 + k], the (T, n, 3) stack of Table.quotients.

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kQMaxColumns = 11;  // the processor table's full width
constexpr int kQMaxParams = 4;

// what a launcher returns for arguments the compiled program does not take
// (cudaError_t codes are positive)
constexpr int kQBadTable = -1;
constexpr int kQBadKey = -2;
constexpr int kQBadShape = -3;

struct QCol {
  const uint64_t* ptr;
  long long is, cs;
};

struct QuotientArgs {
  QCol cur[kQMaxColumns];  // base columns, then extension columns
  QCol nxt[kQMaxColumns];
  QCol zinv[3];            // boundary, transition, terminal (cs unused)
  const uint64_t* ch;      // (11, 3) challenges, contiguous
  const uint64_t* tm;      // (5, 3) terminals, contiguous
  uint64_t* out;           // (T, n, 3), contiguous
  long long n, rot;
  long long params[kQMaxParams];
};

GL_FN uint64_t q_load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The generated bodies' view of one position: r.base(c, nxt), r.ext(c,
// nxt) (c counts the base columns first, as the launcher's columns do),
// r.zinv(kind), r.param(s), r.store(t, value). c, nxt and kind are
// constants of the generated code, so every access is resolved at compile
// time.
struct QuotientRow {
  const QuotientArgs& A;
  long long i, j;  // the row and the next row

  GL_FN uint64_t base(int c, int nxt) const {
    const QCol& q = nxt ? A.nxt[c] : A.cur[c];
    return q_load(q.ptr + (nxt ? j : i) * q.is);
  }

  GL_FN Xf ext(int c, int nxt) const {
    const QCol& q = nxt ? A.nxt[c] : A.cur[c];
    const uint64_t* v = q.ptr + (nxt ? j : i) * q.is;
    return Xf{q_load(v), q_load(v + q.cs), q_load(v + 2 * q.cs)};
  }

  GL_FN uint64_t zinv(int kind) const {
    return q_load(A.zinv[kind].ptr + i * A.zinv[kind].is);
  }

  GL_FN long long param(int s) const { return A.params[s]; }

  GL_FN void store(int t, const Xf& v) const {
    uint64_t* o = A.out + 3 * (t * A.n + i);
    o[0] = v.c0;
    o[1] = v.c1;
    o[2] = v.c2;
  }
};

}  // namespace

#include "quotients_gen.cuh"

namespace {

// Q of table `table` (the order of the prover's tables), f(Q{}) called with
// it; kQBadTable for another index.
template <class F>
int with_table(int table, F f) {
  switch (table) {
#define QUOTIENT_CASE(index, Q) \
  case index:                   \
    return f(Q{});
    QUOTIENT_TABLES(QUOTIENT_CASE)
#undef QUOTIENT_CASE
    default:
      return kQBadTable;
  }
}

// A from the launcher's flat arguments, or why not: `cols` holds 2 x ncols
// triples (address, position stride, coefficient stride), the columns at
// the row then at the next row, `zinv` 3 pairs (address, stride). The key
// is the recorded program's (`Program.key`): another key means the models
// changed since quotients_gen.cuh was emitted.
template <class Q>
int quotient_args(uint64_t key, const long long* cols, int ncols,
                  const long long* zinv, const void* ch, const void* tm,
                  const long long* params, int nparams, long long n,
                  long long rot, void* out, QuotientArgs& A) {
  static_assert(Q::kBase + Q::kExt <= kQMaxColumns &&
                Q::kParams <= kQMaxParams, "a table outgrew QuotientArgs");
  if (key != Q::kKey) return kQBadKey;
  if (ncols != Q::kBase + Q::kExt || nparams != Q::kParams || n < 0 ||
      rot < 0 || (n > 0 && rot >= n))
    return kQBadShape;
  for (int c = 0; c < ncols; ++c) {
    for (int s = 0; s < 2; ++s) {
      const long long* t = cols + 3 * (s * ncols + c);
      QCol& q = s ? A.nxt[c] : A.cur[c];
      q.ptr = reinterpret_cast<const uint64_t*>(t[0]);
      q.is = t[1];
      q.cs = t[2];
    }
  }
  for (int k = 0; k < 3; ++k) {
    A.zinv[k].ptr = reinterpret_cast<const uint64_t*>(zinv[2 * k]);
    A.zinv[k].is = zinv[2 * k + 1];
    A.zinv[k].cs = 0;
  }
  A.ch = static_cast<const uint64_t*>(ch);
  A.tm = static_cast<const uint64_t*>(tm);
  A.out = static_cast<uint64_t*>(out);
  A.n = n;
  A.rot = rot;
  for (int s = 0; s < nparams; ++s) A.params[s] = params[s];
  return 0;
}

}  // namespace
