// Kernel F5: one FRI fold round on the card, (N, 3) F_p^3 words -> (N/2, 3),
// the body of fri.cuh. It replaces the JAX package's compiled fold,
// stark_brainfuck_tpu/protocol/fri.py:55 `_fold_device` (staged as
// `fri.fold.n{N}.tree{t}`), whose arithmetic is `_fold_math` (:39); the
// port ran it as 2·log2(N/2) + 3 F1 and 3 F2 launches, log2(N/2) copies of
// `geometric_rows` and two uploads a round.
//
// What bounds it: bytes. A round reads 24N bytes and writes 12N, 75.5 MB
// or 22.5 us at 3.35 TB/s for N = 2^21; its 16 Goldilocks multiplies, 12
// adds and 5 subs an output take about 20 us on the ALU pipe
// (chip_smoke.py `fold_work`).
//
// Design (a simple kernel that is right first):
//   - one thread for kFoldPerThread outputs, kFoldThreads apart, so that a
//     warp's loads and stores cover neighbouring words;
//   - x_i^-1 is computed, never stored: each thread raises r to its block's
//     first index (uniform over the block) and then to its own offset with
//     the ladder, and steps by r^kFoldThreads from there;
//   - the constants travel by value in the launch (`FriFold`), so a round
//     makes no host-to-device copy.

#include <cstdint>
#include <cuda_runtime.h>

#include "fri.cuh"

namespace {

constexpr int kFoldThreads = 128;
constexpr int kFoldLogThreads = 7;
constexpr int kFoldPerThread = 8;
constexpr long long kFoldBlock = (long long)kFoldThreads * kFoldPerThread;

__global__ void __launch_bounds__(kFoldThreads)
fri_fold_kernel(const uint64_t* __restrict__ cw, uint64_t* __restrict__ out,
                long long half, const __grid_constant__ FriFold F) {
  const long long first = (long long)blockIdx.x * kFoldBlock;
  uint64_t x = fri_step(F, F.start, (unsigned long long)first);
  x = fri_step(F, x, threadIdx.x);
  const uint64_t step = F.ladder[kFoldLogThreads];
#pragma unroll
  for (int j = 0; j < kFoldPerThread; ++j) {
    const long long i = first + (long long)j * kFoldThreads + threadIdx.x;
    if (i >= half) break;
    fri_store(out, i, fri_fold_at(F, x, fri_load(cw, i),
                                  fri_load(cw, i + half)));
    x = gl_mul(x, step);
  }
}

}  // namespace

// F5. Folds the (2·half, 3) codeword `cw` into `out` (half, 3), both
// contiguous u64 words on the card, with the kFoldWords constants `words`
// (host memory, read before the launch returns), on `stream`, one launch.
// Returns 0 or a cudaError_t.
extern "C" int fri_fold_launch(const void* cw, long long half,
                               const unsigned long long* words, void* out,
                               void* stream) {
  if (half <= 0) return 0;
  const FriFold F = fri_fold_args(words);
  const long long blocks = (half + kFoldBlock - 1) / kFoldBlock;
  fri_fold_kernel<<<(unsigned int)blocks, kFoldThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cw), static_cast<uint64_t*>(out), half, F);
  return (int)cudaGetLastError();
}
