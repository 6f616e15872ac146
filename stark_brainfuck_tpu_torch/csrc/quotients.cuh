// Kernel F4's operands and row access, shared by the kernel (quotients.cu)
// and its host harness (native/quotients_host.cpp): each table's boundary,
// transition and terminal quotients at position i, the bodies generated
// from the models into quotients_gen.cuh, the permutation arguments' two
// difference quotients, and what a body's `r.store(t, v)` does with
// quotient t.
//
// A column is (address, position stride, coefficient stride) in words, read
// where it lies: the LDE's column views, a zero-stride view of one zero
// word for an empty table, a 0-dim zerofier inverse (position stride 0).
// The next row of column c is its `nxt` column at position (i + rot) mod n:
// the same column with rot = the table's row shift (resident: its unit
// distance; a streamed class: unit distance / B), or columns the caller
// rolled itself (a mesh) with rot = 0.
//
// Sinks take the stores. The kernel's: BufferSink writes a table's
// quotients into the thread's buffer (3 words an extension quotient, 1 a
// base one), and `weigh_buffer` then weighs them one after another with
// WeighSink into the position's lazy sums (accumulate.cuh) as terms
// `term0 + t` of the combination, so the kernel's only output is acc.
// StackSink, the host harness's second form, writes quotient t to out[(t n
// + i) 3 + k], the (T, n, 3) stack of Table.quotients, which the tests hold
// to the op-by-op stack.

#pragma once

#include <cstdint>
#include <type_traits>

#include "accumulate.cuh"
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

// one table's operands
struct QTableArgs {
  QCol cur[kQMaxColumns];  // base columns, then extension columns
  QCol nxt[kQMaxColumns];
  QCol zinv[3];            // boundary, transition, terminal (cs unused)
  long long rot;
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
// r.zinv(kind), r.param(s), and r.store(t, value) of an extension or a
// base quotient. c, nxt, kind and t are constants of the generated code,
// so every access is resolved at compile time.
template <class Sink>
struct QuotientRow {
  const QTableArgs& A;
  long long i, j;  // the row and the next row
  Sink& sink;

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

  GL_FN void store(int t, const Xf& v) const { sink.ext(t, v); }
  GL_FN void store(int t, uint64_t v) const { sink.base(t, v); }
};

// quotient t at position i into the (T, n, 3) stack `out`
struct StackSink {
  uint64_t* out;
  long long n, i;

  GL_FN void ext(int t, const Xf& v) const {
    uint64_t* o = out + 3 * (t * n + i);
    o[0] = v.c0;
    o[1] = v.c1;
    o[2] = v.c2;
  }
  GL_FN void base(int t, uint64_t v) const { ext(t, Xf{v, 0, 0}); }
};

// quotient t as term k = term0 + t of the combination: s += (w_plain +
// w_shift x^s) q, with w[k] the term's `term_start` words at the block's
// first position and its x^s table word at x[xoff[k]]: x is the position's
// word of the first power table row, xoff[k] the offset of the term's
// shift's row (the terms of one shift read one word)
struct WeighSink {
  Sum160* s;  // the position's three sums
  const uint64_t (*w)[6];
  const uint64_t* x;
  const int* xoff;
  int term0;

  GL_FN void ext(int t, const Xf& v) const {
    const int k = term0 + t;
    acc_ext_term(s, w[k], q_load(x + xoff[k]), v.c0, v.c1, v.c2);
  }
  GL_FN void base(int t, uint64_t v) const {
    const int k = term0 + t;
    acc_base_term(s, w[k], q_load(x + xoff[k]), v);
  }
};

}  // namespace

#include "quotients_gen.cuh"

namespace {

// QTable<index>::type, the generated struct of each table, in the order
// of the prover's tables
template <int I>
struct QTable;
#define QUOTIENT_TYPE(index, Q) \
  template <>                   \
  struct QTable<index> {        \
    using type = Q;             \
  };
QUOTIENT_TABLES(QUOTIENT_TYPE)
#undef QUOTIENT_TYPE

#define QUOTIENT_COUNT(index, Q) +1
#define QUOTIENT_OUTPUTS(index, Q) +Q::kOutputs
#define QUOTIENT_UNIFORM(index, Q) +Q::kUniform
constexpr int kQTables = 0 QUOTIENT_TABLES(QUOTIENT_COUNT);
constexpr int kQOutputs = 0 QUOTIENT_TABLES(QUOTIENT_OUTPUTS);
constexpr int kQUniform = 0 QUOTIENT_TABLES(QUOTIENT_UNIFORM);
#undef QUOTIENT_COUNT
#undef QUOTIENT_OUTPUTS
#undef QUOTIENT_UNIFORM
// the combination's terms: every table's quotients, then the two
// permutation arguments' difference quotients
constexpr int kQTerms = kQOutputs + 2;

// the permutation quotients read the processor's, the instruction's and
// the memory table's first extension columns
static_assert(std::is_same<QTable<0>::type, QuotientsProcessor>::value &&
                  std::is_same<QTable<1>::type, QuotientsInstruction>::value &&
                  std::is_same<QTable<2>::type, QuotientsMemory>::value,
              "the permutation arguments need tables 0, 1, 2");

// quotients and uniform values of the tables before table I
template <int I>
constexpr int terms_before() {
  if constexpr (I == 0)
    return 0;
  else
    return terms_before<I - 1>() + QTable<I - 1>::type::kOutputs;
}

template <int I>
constexpr int uniform_before() {
  if constexpr (I == 0)
    return 0;
  else
    return uniform_before<I - 1>() + QTable<I - 1>::type::kUniform;
}

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

// A from one table's flat arguments, or why not: `cols` holds 2 x ncols
// triples (address, position stride, coefficient stride), the columns at
// the row then at the next row, `zinv` 3 pairs (address, stride). The key
// is the recorded program's (`Program.key`): another key means the models
// changed since quotients_gen.cuh was emitted.
template <class Q>
int table_args(uint64_t key, const long long* cols, int ncols,
               const long long* zinv, const long long* params, int nparams,
               long long n, long long rot, QTableArgs& A) {
  static_assert(Q::kBase + Q::kExt <= kQMaxColumns &&
                Q::kParams <= kQMaxParams, "a table outgrew QTableArgs");
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
  A.rot = rot;
  for (int s = 0; s < nparams; ++s) A.params[s] = params[s];
  return 0;
}

// Kernel F4's operands: the five tables', the weights, the power tables
// (a row a distinct shift, `slot` naming each term's) and the uniform
// values the prologue made, acc
struct FusedArgs {
  QTableArgs table[kQTables];
  const uint64_t* w;       // (kQTerms, 2, 3): w_plain, w_shift
  const uint64_t* tables;  // (shifts, row)
  const uint64_t* u;       // 3 kQUniform words: every table's uniform values
  uint64_t* acc;           // (n, 3), contiguous
  long long n, row;
  int shifts;
  unsigned char slot[kQTerms];
};

template <int I = 0>
int tables_args(const unsigned long long* keys, const long long* cols,
                const int* ncols, const long long* zinv,
                const long long* params, const int* nparams,
                const long long* rots, long long n, FusedArgs& A) {
  if constexpr (I == kQTables) {
    return 0;
  } else {
    const int rc = table_args<typename QTable<I>::type>(
        keys[I], cols, ncols[I], zinv + 6 * I, params + kQMaxParams * I,
        nparams[I], n, rots[I], A.table[I]);
    if (rc) return rc;
    return tables_args<I + 1>(keys, cols + 6 * ncols[I], ncols, zinv, params,
                              nparams, rots, n, A);
  }
}

// A from the launcher's flat arguments, or why not: each table's as
// table_args (its columns in `cols` one table after the other, zinv 6
// words a table, params kQMaxParams a table), `terms` = kQTerms weights,
// each term's slot below `shifts`
int fused_args(const unsigned long long* keys, const long long* cols,
               const int* ncols, const long long* zinv,
               const long long* params, const int* nparams,
               const long long* rots, long long n, const void* w,
               const unsigned char* slots, int terms, int shifts, void* acc,
               FusedArgs& A) {
  if (terms != kQTerms || shifts < 1 || shifts > kQTerms) return kQBadShape;
  for (int t = 0; t < terms; ++t) {
    if (slots[t] >= shifts) return kQBadShape;
    A.slot[t] = slots[t];
  }
  const int rc =
      tables_args(keys, cols, ncols, zinv, params, nparams, rots, n, A);
  if (rc) return rc;
  A.w = static_cast<const uint64_t*>(w);
  A.acc = static_cast<uint64_t*>(acc);
  A.n = n;
  A.shifts = shifts;
  A.tables = nullptr;
  A.u = nullptr;
  A.row = 0;
  return 0;
}

// every table's uniform values (the values no column enters) into u
template <int I = 0>
GL_FN void fused_uniform(const FusedArgs& A, const uint64_t* ch,
                         const uint64_t* tm, Xf* u) {
  if constexpr (I < kQTables) {
    QTable<I>::type::uniform(ch, tm, A.table[I].params,
                             u + uniform_before<I>());
    fused_uniform<I + 1>(A, ch, tm, u);
  }
}

// quotient t of Q at word q_offset<Q>(t) of a buffer: 3 words an
// extension quotient, 1 a base one
template <class Q>
GL_FN constexpr int q_offset(int t) {
  int o = 0;
  for (int k = 0; k < t; ++k) o += ((Q::kExtMask >> k) & 1) ? 3 : 1;
  return o;
}

template <int I = 0>
constexpr int buffer_words() {
  if constexpr (I == kQTables) {
    return 0;
  } else {
    using Q = typename QTable<I>::type;
    const int rest = buffer_words<I + 1>();
    return q_offset<Q>(Q::kOutputs) > rest ? q_offset<Q>(Q::kOutputs) : rest;
  }
}
constexpr int kQBufferWords = buffer_words();

// a table's quotients into a thread's buffer, word k at q[k nt]
template <class Q>
struct BufferSink {
  uint64_t* q;
  int nt;

  GL_FN void ext(int t, const Xf& v) const {
    uint64_t* p = q + q_offset<Q>(t) * nt;
    p[0] = v.c0;
    p[nt] = v.c1;
    p[2 * nt] = v.c2;
  }
  GL_FN void base(int t, uint64_t v) const { q[q_offset<Q>(t) * nt] = v; }
};

// the quotients BufferSink<Q> wrote, weighed in order; a loop, so that
// the compiler neither hoists the weighing's loads into the table's body
// nor the next table's body into the weighing
template <class Q>
GL_FN void weigh_buffer(const WeighSink& sink, const uint64_t* q, int nt) {
  int o = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int t = 0; t < Q::kOutputs; ++t) {
    if ((Q::kExtMask >> t) & 1) {
      sink.ext(t, Xf{q[o * nt], q[(o + 1) * nt], q[(o + 2) * nt]});
      o += 3;
    } else {
      sink.base(t, q[o * nt]);
      o += 1;
    }
  }
}

// tables I .. kQTables - 1 at position i: each table's body into this
// thread's buffer (word k at q[k nt]), then weighed into sink's sums
template <int I = 0>
GL_FN void weigh_tables(const FusedArgs& A, long long i, WeighSink& sink,
                        const Xf* u, uint64_t* q, int nt) {
  if constexpr (I < kQTables) {
    using Q = typename QTable<I>::type;
    const QTableArgs& T = A.table[I];
    long long j = i + T.rot;
    if (j >= A.n) j -= A.n;
    const BufferSink<Q> b{q, nt};
    Q::row(QuotientRow<const BufferSink<Q>>{T, i, j, b},
           u + uniform_before<I>());
    sink.term0 = terms_before<I>();
    weigh_buffer<Q>(sink, q, nt);
    weigh_tables<I + 1>(A, i, sink, u, q, nt);
  }
}

// Position i of kernel F4: every table's quotients, then the permutation
// arguments' (processor - instruction and processor - memory, each times
// the processor's boundary zerofier inverse), weighed into sink's sums in
// the combination's order, and the sums added to acc[i]
GL_FN void weigh_position(const FusedArgs& A, long long i, const Xf* u,
                          WeighSink& sink, uint64_t* q, int nt) {
  weigh_tables(A, i, sink, u, q, nt);
  using P = QTable<0>::type;
  const QuotientRow<WeighSink> p{A.table[0], i, i, sink};
  const QuotientRow<WeighSink> in{A.table[1], i, i, sink};
  const QuotientRow<WeighSink> m{A.table[2], i, i, sink};
  const uint64_t zb = p.zinv(0);
  sink.term0 = kQOutputs;
  sink.ext(0, xf_mul_base(
                  xf_sub(p.ext(P::kBase, 0),
                         in.ext(QTable<1>::type::kBase, 0)),
                  zb));
  sink.ext(1, xf_mul_base(
                  xf_sub(p.ext(P::kBase + 1, 0),
                         m.ext(QTable<2>::type::kBase, 0)),
                  zb));
  uint64_t* o = A.acc + 3 * i;
  for (int k = 0; k < 3; ++k) o[k] = gl_add(o[k], reduce160(sink.s[k]));
}

}  // namespace
