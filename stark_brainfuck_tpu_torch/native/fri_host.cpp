// FRI's host tail: the fold rounds of codewords shorter than `host_min`
// (and every round under the reference codec), the counterpart of the JAX
// package's numpy fold (stark_brainfuck_tpu/protocol/fri.py:347-362). The
// body is kernel F5's (csrc/fri.cuh) in a loop, compiled with g++.
//
// Exposed C ABI (ctypes):
//   fri_fold_host(cw, half, words, out)  - out[i] for i < half from the
//                                          (2·half, 3) u64 codeword cw,
//                                          both contiguous, with F5's
//                                          kFoldWords constants

#include <cstdint>

#include "../csrc/fri.cuh"

namespace {

// outputs a chunk: each starts from the ladder, then steps by r
constexpr long long kChunk = 1024;
// Rounds below this many outputs fold on the calling thread: a parallel
// region's start and barrier cost more than a round of one chunk. On an
// 8-CPU host, rounds of 1,024 outputs and fewer folded fastest on one
// thread and rounds of 2,048 and more (two chunks) on all of them
// (chip_smoke.py's fold_parallel_min_sweep); a build may set it with
// -DFRI_FOLD_PARALLEL_MIN=<outputs>.
#ifndef FRI_FOLD_PARALLEL_MIN
#define FRI_FOLD_PARALLEL_MIN 2048
#endif
constexpr long long kParallelMin = FRI_FOLD_PARALLEL_MIN;

}  // namespace

extern "C" void fri_fold_host(const void* cw, long long half,
                              const unsigned long long* words, void* out) {
  const FriFold F = fri_fold_args(words);
  const uint64_t* c = static_cast<const uint64_t*>(cw);
  uint64_t* o = static_cast<uint64_t*>(out);
  const long long chunks = (half + kChunk - 1) / kChunk;
#pragma omp parallel for schedule(static) if (half >= kParallelMin)
  for (long long b = 0; b < chunks; ++b) {
    const long long lo = b * kChunk;
    const long long hi = lo + kChunk < half ? lo + kChunk : half;
    uint64_t x = fri_step(F, F.start, (unsigned long long)lo);
    for (long long i = lo; i < hi; ++i) {
      fri_store(o, i, fri_fold_at(F, x, fri_load(c, i), fri_load(c, i + half)));
      x = gl_mul(x, F.ladder[0]);
    }
  }
}
