// Kernel F4's body on the host: the generated quotient programs of
// csrc/quotients_gen.cuh, compiled with g++ through the same row access
// (csrc/quotients.cuh) and the portable form of the field helpers
// (csrc/goldilocks.cuh), one position after another. The prover never
// calls it: it lets a machine without a card hold the emitted C++ to the
// plain torch stack (tests/test_torch_quotient_kernel.py), so a fault in
// the emitter shows without nvcc.
//
// Exposed C ABI (ctypes):
//   quotients_host(table, key, cols, ncols, zinv, ch, tm, params, nparams,
//                  n, rot, out)         - quotients_launch without a stream

#include <cstdint>

#include "../csrc/quotients.cuh"

extern "C" int quotients_host(int table, unsigned long long key,
                              const long long* cols, int ncols,
                              const long long* zinv, const void* ch,
                              const void* tm, const long long* params,
                              int nparams, long long n, long long rot,
                              void* out) {
  return with_table(table, [&](auto q) {
    using Q = decltype(q);
    QuotientArgs A;
    const int rc = quotient_args<Q>(key, cols, ncols, zinv, ch, tm, params,
                                    nparams, n, rot, out, A);
    if (rc) return rc;
    Xf u[Q::kUniform > 0 ? Q::kUniform : 1];
    Q::uniform(A.ch, A.tm, A.params, u);
    for (long long i = 0; i < n; ++i) {
      long long j = i + rot;
      if (j >= n) j -= n;
      Q::row(QuotientRow{A, i, j}, u);
    }
    return 0;
  });
}
