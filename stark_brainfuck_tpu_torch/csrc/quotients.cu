// Kernel F4 for Hopper (sm_90a): one table's AIR quotients over a
// codeword, in one launch.
//
//   F4  quotients_kernel<Q>   Table.quotients of table Q at every position
//
// It replaces no Pallas kernel. The JAX package stages each table's
// `_table_quotient_stack` (stark_brainfuck_tpu/protocol/stark.py) as one
// jitted executable, `comb_quot{ti}`, and XLA fuses the table's whole
// constraint expression into it. Run op by op, the port dispatched about
// 100 F1/F2 launches a table for the same values (369 and 107 for the five
// tables), with a torch.cat for every base operand lifted to the extension
// and a torch.roll copy of every column for the next row. F4 is the port's
// counterpart of that fused stage: protocol/stark.py `_table_quotient_stack`
// sends CUDA operands here (ops/quotient_kernels.py).
//
// The constraint bodies are not written by hand: ops/quotient_kernels.py
// records each table's `Table.quotients` as a straight-line program
// (models/interp.py `ProgramAlgebra`), folds constants, merges common
// subexpressions, drops dead nodes and emits it as C++ into
// quotients_gen.cuh, which is committed and checked against a fresh emit by
// the tests. A program's key travels with every launch, so a library built
// from a stale emit refuses to run.
//
// Design (a simple kernel that is right first). What bounds it: the
// integer multiplies. A position of all five tables reads about 57 words and
// writes 144 (1.6 KB), against about 540 Goldilocks multiplies; the
// chip_smoke.py bound counts both exactly from the emitted programs.
//   - one thread a position, over a grid-stride loop, one wave of blocks
//     (the SMs times the blocks the kernel's registers let an SM hold);
//   - the values that depend only on the challenges, terminals and
//     exponents (the IO tables' iota^(height - length) among them) are
//     computed once a block by its first thread into shared memory;
//   - every column word is loaded where it lies, once a position, the next
//     row at (i + rot) mod n, so no rolled or concatenated copy exists; the
//     three zerofier inverses likewise;
//   - each output is stored as soon as it is computed, three words of the
//     (T, n, 3) stack that F3 consumes.
// Field arithmetic is exact, so the evaluation order changes no bit: the
// result equals the op-by-op stack word for word.

#include <cstdint>
#include <cuda_runtime.h>

#include "quotients.cuh"

namespace {

constexpr int kQThreads = 128;

template <class Q>
__global__ void __launch_bounds__(kQThreads)
quotients_kernel(const __grid_constant__ QuotientArgs A) {
  __shared__ Xf s_u[Q::kUniform > 0 ? Q::kUniform : 1];
  if (threadIdx.x == 0) Q::uniform(A.ch, A.tm, A.params, s_u);
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < A.n; i += step) {
    long long j = i + A.rot;
    if (j >= A.n) j -= A.n;
    const QuotientRow r{A, i, j};
    Q::row(r, s_u);
  }
}

// blocks of one wave of quotients_kernel<Q> on the current device (asked
// once a table: the port drives one kind of card)
template <class Q>
int wave_blocks(long long& blocks) {
  static long long wave = 0;
  if (wave == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quotients_kernel<Q>, kQThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = wave;
  return 0;
}

}  // namespace

// F4. The quotients of table `table` (0 processor, 1 instruction, 2
// memory, 3 input, 4 output) at positions 0 .. n-1 into `out` (T, n, 3),
// on `stream`, one launch. Arguments as quotient_args (quotients.cuh);
// returns 0, a cudaError_t, or a negative kQBad* code for arguments the
// compiled program does not take.
extern "C" int quotients_launch(int table, unsigned long long key,
                                const long long* cols, int ncols,
                                const long long* zinv, const void* ch,
                                const void* tm, const long long* params,
                                int nparams, long long n, long long rot,
                                void* out, void* stream) {
  return with_table(table, [&](auto q) {
    using Q = decltype(q);
    QuotientArgs A;
    int rc = quotient_args<Q>(key, cols, ncols, zinv, ch, tm, params,
                              nparams, n, rot, out, A);
    if (rc || n == 0) return rc;
    long long wave = 0;
    if ((rc = wave_blocks<Q>(wave))) return rc;
    const long long need = (n + kQThreads - 1) / kQThreads;
    const long long blocks = need < wave ? need : wave;
    quotients_kernel<Q><<<(unsigned int)blocks, kQThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(A);
    return (int)cudaGetLastError();
  });
}
