// Kernel F4's body on the host: the generated quotient programs of
// csrc/quotients_gen.cuh and the weighing of csrc/quotients.cuh, compiled
// with g++ through the same row access and sinks and the portable forms of
// the field helpers (csrc/goldilocks.cuh) and of the lazy sums
// (csrc/accumulate.cuh), one position after another. The prover never
// calls it: it lets a machine without a card hold the emitted C++ and the
// kernel's weighing to the plain torch versions
// (tests/test_torch_quotient_kernel.py), so a fault in the emitter or the
// weighing shows without nvcc.
//
// Exposed C ABI (ctypes):
//   quotients_host(table, key, cols, ncols, zinv, ch, tm, params, nparams,
//                  n, rot, out)      - one table's (T, n, 3) stack
//   quotients_acc_host(keys, cols, ncols, zinv, params, nparams, rots, n,
//                      ch, tm, w, ratios, starts, slots, terms, shifts,
//                      acc)          - quotients_launch without its scratch
//                                      and stream, in blocks of 128
//                                      positions as the kernel's

#include <cstdint>
#include <vector>

#include "../csrc/quotients.cuh"

namespace {

constexpr int kHostBlock = 128;

// the device prologue's power table row (accumulate.cuh `power_row`), one
// entry after another
void host_power_row(uint64_t r, uint64_t start, uint64_t* row,
                    long long top) {
  uint64_t* mid = row + kAccTile;
  uint64_t* hi = mid + kAccMid;
  row[0] = 1;
  for (int j = 1; j < kAccTile; ++j) row[j] = gl_mul(row[j - 1], r);
  const uint64_t r_tile = gl_mul(row[kAccTile - 1], r);
  mid[0] = 1;
  for (int m = 1; m < kAccMid; ++m) mid[m] = gl_mul(mid[m - 1], r_tile);
  const uint64_t r_top = gl_mul(mid[kAccMid - 1], r_tile);
  hi[0] = start;
  for (long long h = 1; h < top; ++h) hi[h] = gl_mul(hi[h - 1], r_top);
}

}  // namespace

extern "C" int quotients_host(int table, unsigned long long key,
                              const long long* cols, int ncols,
                              const long long* zinv, const void* ch,
                              const void* tm, const long long* params,
                              int nparams, long long n, long long rot,
                              void* out) {
  return with_table(table, [&](auto q) {
    using Q = decltype(q);
    QTableArgs A;
    const int rc = table_args<Q>(key, cols, ncols, zinv, params, nparams, n,
                                 rot, A);
    if (rc) return rc;
    Xf u[Q::kUniform > 0 ? Q::kUniform : 1];
    Q::uniform(static_cast<const uint64_t*>(ch),
               static_cast<const uint64_t*>(tm), A.params, u);
    for (long long i = 0; i < n; ++i) {
      long long j = i + rot;
      if (j >= n) j -= n;
      StackSink sink{static_cast<uint64_t*>(out), n, i};
      Q::row(QuotientRow<StackSink>{A, i, j, sink}, u);
    }
    return 0;
  });
}

extern "C" int quotients_acc_host(
    const unsigned long long* keys, const long long* cols, const int* ncols,
    const long long* zinv, const long long* params, const int* nparams,
    const long long* rots, long long n, const void* ch, const void* tm,
    const void* w, const void* ratios, const void* starts,
    const unsigned char* slots, int terms, int shifts, void* acc) {
  FusedArgs A;
  const int rc = fused_args(keys, cols, ncols, zinv, params, nparams, rots,
                            n, w, slots, terms, shifts, acc, A);
  if (rc || n == 0) return rc;
  const long long top = (n + (1LL << kAccLogTop) - 1) >> kAccLogTop;
  A.row = kAccTile + kAccMid + top;
  std::vector<uint64_t> tables(shifts * A.row);
  for (int d = 0; d < shifts; ++d)
    host_power_row(static_cast<const uint64_t*>(ratios)[d],
                   static_cast<const uint64_t*>(starts)[d],
                   &tables[d * A.row], top);
  A.tables = tables.data();
  Xf u[kQUniform];
  fused_uniform(A, static_cast<const uint64_t*>(ch),
                static_cast<const uint64_t*>(tm), u);
  uint64_t w6[kQTerms][6], q[kQBufferWords];
  int xoff[kQTerms];
  for (int t = 0; t < kQTerms; ++t) xoff[t] = A.slot[t] * (int)A.row;
  for (long long tile0 = 0; tile0 < n; tile0 += kHostBlock) {
    for (int t = 0; t < kQTerms; ++t)
      term_start(&tables[A.slot[t] * A.row], tile0, A.w + 6 * t, w6[t]);
    for (long long i = tile0; i < n && i < tile0 + kHostBlock; ++i) {
      // kHostBlock divides kAccTile: position i's table word is r^(i mod
      // kAccTile)
      Sum160 s[3] = {};
      WeighSink sink{s, w6, &tables[i & (kAccTile - 1)], xoff, 0};
      weigh_position(A, i, u, sink, q, 1);
    }
  }
  return 0;
}
