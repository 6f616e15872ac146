// Kernel F4 for Hopper (sm_90a): every table's AIR quotients and the two
// permutation quotients, weighed into the combination, in one launch.
//
//   F4  quotients_kernel   acc[i] += sum_t (w_plain_t + w_shift_t x^s_t(i))
//                          q_t(i) over the 48 table quotients and the 2
//                          permutation quotients, in place
//       quotients_prologue_kernel   its power tables and uniform values
//
// It replaces no Pallas kernel. The JAX package stages each table's
// `_table_quotient_stack` (stark_brainfuck_tpu/protocol/stark.py) as one
// jitted executable, `comb_quot{ti}`, weighs its (T, N, 3) stack into the
// combination with `comb_acc_q{T}`, and does the same for the permutation
// arguments' stack with `comb_pa` and `comb_acc_q2` (stark.py:1386-1428);
// XLA fuses each stage. F4 is the port's counterpart of all twelve
// together: protocol/stark.py `_quotient_combination` sends CUDA operands
// here (ops/quotient_kernels.py), one launch a resident combination, a
// mesh rank's block or a streamed class, after F3 has weighed the base and
// extension columns into acc on the same stream.
//
// The constraint bodies are not written by hand: ops/quotient_kernels.py
// records each table's `Table.quotients` as a straight-line program
// (models/interp.py `ProgramAlgebra`), folds constants, merges common
// subexpressions, drops dead nodes and emits it as C++ into
// quotients_gen.cuh, which is committed and checked against a fresh emit by
// the tests. Each program's key travels with every launch, so a library
// built from a stale emit refuses to run.
//
// Design. What bounds it: the integer instructions, on the ALU pipe. A
// position reads 58 column and zerofier words and reads and writes acc's
// 3 (0.5 KB), against 367 Goldilocks multiplies of the bodies, and 100
// more and 375 wide products of the weighing; chip_smoke.py
// `quotient_work` counts every instruction from the emitted programs. An earlier form stored each
// table's (T, n, 3) stack, 144 words a position, and F3 read them back in
// five more launches. Now:
//   - no stack in device memory: a table's body writes its quotients into
//     the thread's buffer in shared memory (at most 41 words, the
//     processor's 10 extension and 11 base quotients), and a loop then
//     weighs them into three lazy 160-bit sums (accumulate.cuh, F3's),
//     reduced once a position; a base quotient costs one multiply and six
//     products, an extension one three multiplies and nine; the only
//     output is acc. Weighing each quotient inside the straight-line body
//     let the compiler hoist the weighing's loads and interleave the five
//     bodies, which spilled and ran about twice as long;
//   - one thread a position runs the five bodies one after another, then
//     the two permutation quotients, whose columns the bodies have just
//     read (L1);
//   - the x^s factors come from F3's power tables, one row a distinct
//     shift (the 50 terms have 12-15 shifts), built by the prologue launch:
//     a block makes each term's start w_shift * start * r^tile0 once (four
//     multiplies), and a term's factor at a position is one table word,
//     the same word for the terms of one shift (an L1 hit after the first;
//     a shared-memory copy of one word a shift cost occupancy and time);
//   - the values that depend only on the challenges, terminals and the IO
//     tables' exponents are computed once a launch, by the prologue's last
//     block, and copied into each block's shared memory;
//   - a block is 128 threads (64 or 32 where n leaves the card's block
//     slots short of one wave: quotients_plan), at most 96 registers a
//     thread, so that an SM holds 5 blocks (20 warps; the buffers take
//     42 KB a block).
// Field arithmetic is exact, so the evaluation order changes no bit: acc
// equals the op-by-op stacks weighed by F3's plain version word for word.

#include <cstdint>
#include <cuda_runtime.h>

#include "quotients.cuh"

namespace {

// the most threads a block, and the blocks of that size an SM must hold
// (the register cap: 96 a thread)
constexpr int kQThreads = 128;
constexpr int kQBlocksPerSm = 5;

// blocks 0 .. shifts - 1: power table rows; block `shifts`: the uniform
// values of every table
__global__ void __launch_bounds__(kQThreads)
quotients_prologue_kernel(const __grid_constant__ FusedArgs A,
                          const uint64_t* __restrict__ ratios,
                          const uint64_t* __restrict__ starts,
                          const uint64_t* __restrict__ ch,
                          const uint64_t* __restrict__ tm,
                          uint64_t* __restrict__ tables,
                          uint64_t* __restrict__ u, long long top) {
  const int b = blockIdx.x;
  if (b < A.shifts) {
    power_row(ratios[b], starts[b], tables + b * A.row, top);
  } else if (threadIdx.x == 0) {
    fused_uniform(A, ch, tm, reinterpret_cast<Xf*>(u));
  }
}

__global__ void __launch_bounds__(kQThreads, kQBlocksPerSm)
quotients_kernel(const __grid_constant__ FusedArgs A) {
  // each thread's quotient buffer, word k of thread tid at s_q[k nt +
  // tid]; each term's start words and the offset of its shift's power
  // table row; the uniform values
  extern __shared__ uint64_t s_q[];
  __shared__ uint64_t s_w[kQTerms][6];
  __shared__ int s_xoff[kQTerms];
  __shared__ Xf s_u[kQUniform];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long tile0 = (long long)blockIdx.x * nt;
  for (int k = tid; k < 3 * kQUniform; k += nt)
    reinterpret_cast<uint64_t*>(s_u)[k] = A.u[k];
  for (int t = tid; t < kQTerms; t += nt) {
    term_start(A.tables + A.slot[t] * A.row, tile0, A.w + 6 * t, s_w[t]);
    s_xoff[t] = A.slot[t] * (int)A.row;
  }
  __syncthreads();
  const long long i = tile0 + tid;
  if (i >= A.n) return;
  Sum160 s[3] = {};
  // nt divides kAccTile and tile0: position i's table word is r^(i mod
  // kAccTile)
  WeighSink sink{s, s_w, A.tables + (i & (kAccTile - 1)), s_xoff, 0};
  weigh_position(A, i, s_u, sink, s_q + tid, nt);
}

}  // namespace

// F4's launch plan for n positions and `shifts` distinct shifts: out[0]
// threads a block, out[1] blocks, out[2] blocks an SM holds, out[3] SMs,
// out[4] registers a thread, out[5] dynamic shared bytes a block. Of 128,
// 64 and 32 threads, the largest whose blocks fill every block slot of the
// card at least once (32 when none does): a small domain (2^14) still
// reaches every SM.
extern "C" int quotients_plan(long long n, int shifts, long long* out) {
  static int sms = 0, regs = 0, occupancy[3][kQTerms + 1] = {};
  if (n <= 0 || shifts < 1 || shifts > kQTerms)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (!sms) {
    int dev;
    cudaFuncAttributes attr;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaFuncGetAttributes(&attr, quotients_kernel))) return rc;
    if ((rc = (int)cudaFuncSetAttribute(
             quotients_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kQBufferWords * kQThreads * 8)))
      return rc;
    if ((rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return rc;
    regs = attr.numRegs;
  }
  int k = 0, threads = kQThreads;
  for (;; ++k, threads >>= 1) {
    const size_t smem = (size_t)kQBufferWords * threads * 8;
    int& per_sm = occupancy[k][shifts];
    if (!per_sm &&
        (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, quotients_kernel, threads, smem)))
      return rc;
    const long long blocks = (n + threads - 1) / threads;
    if (threads == 32 || blocks >= (long long)sms * per_sm) break;
  }
  out[0] = threads;
  out[1] = (n + threads - 1) / threads;
  out[2] = occupancy[k][shifts];
  out[3] = sms;
  out[4] = regs;
  out[5] = (long long)kQBufferWords * threads * 8;
  return 0;
}

// words of the uniform values' scratch buffer `quotients_launch` takes
extern "C" int quotients_uniform_words() { return 3 * kQUniform; }

// F4. acc (n, 3) += the combination's quotient terms at positions 0 ..
// n-1, in place, on `stream`: the prologue, then one launch. For table k
// (0 processor, 1 instruction, 2 memory, 3 input, 4 output): keys[k] its
// program's key, ncols[k] its columns, whose 2 x ncols[k] triples follow
// the earlier tables' in `cols` (table_args), zinv[6k ..] its 3 zerofier
// inverses, params[kQMaxParams k ..] its nparams[k] exponents, rots[k]
// its row shift. ch (11, 3), tm (5, 3), w (terms, 2, 3) contiguous; ratios
// and starts (shifts,), the x^s progression of each distinct shift, and
// slots[t] term t's; scratch: `tables` shifts x (kAccTile + kAccMid +
// ceil(n / 2^kAccLogTop)) words, `uniform` quotients_uniform_words().
// Returns 0, a cudaError_t, or a negative kQBad* code for arguments the
// compiled programs do not take.
extern "C" int quotients_launch(
    const unsigned long long* keys, const long long* cols, const int* ncols,
    const long long* zinv, const long long* params, const int* nparams,
    const long long* rots, long long n, const void* ch, const void* tm,
    const void* w, const void* ratios, const void* starts,
    const unsigned char* slots, int terms, int shifts, void* tables,
    void* uniform, void* acc, void* stream) {
  FusedArgs A;
  int rc = fused_args(keys, cols, ncols, zinv, params, nparams, rots, n, w,
                      slots, terms, shifts, acc, A);
  if (rc || n == 0) return rc;
  long long plan[6];
  if ((rc = quotients_plan(n, shifts, plan))) return rc;
  if (plan[1] > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long top = (n + (1LL << kAccLogTop) - 1) >> kAccLogTop;
  A.tables = static_cast<const uint64_t*>(tables);
  A.u = static_cast<const uint64_t*>(uniform);
  A.row = kAccTile + kAccMid + top;
  const auto s = static_cast<cudaStream_t>(stream);
  quotients_prologue_kernel<<<shifts + 1, kQThreads, 0, s>>>(
      A, static_cast<const uint64_t*>(ratios),
      static_cast<const uint64_t*>(starts), static_cast<const uint64_t*>(ch),
      static_cast<const uint64_t*>(tm), static_cast<uint64_t*>(tables),
      static_cast<uint64_t*>(uniform), top);
  if ((rc = (int)cudaGetLastError())) return rc;
  quotients_kernel<<<(unsigned int)plan[1], (unsigned int)plan[0],
                     (size_t)plan[5], s>>>(A);
  return (int)cudaGetLastError();
}
