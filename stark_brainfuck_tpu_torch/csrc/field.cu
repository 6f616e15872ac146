// Goldilocks and F_p^3 field kernels for Hopper (sm_90a): the port's
// compiled form of the prover's field arithmetic.
//
//   F1  gl_binary_kernel   elementwise add, sub, mul over p = 2^64 - 2^32 + 1
//   F2  xf_binary_kernel   elementwise F_p^3 mul and mul_base, X^3 = X - 1
//   F3  acc_group_kernel   the weighted accumulation of the combination
//
// None of them replaces a Pallas kernel. On the TPU, XLA fuses the u64
// arithmetic of stark_brainfuck_tpu/ops/field.py (add, sub, mul) and
// ops/xfield.py (mul, mul_base) inside each compiled stage, so that one
// field operation is one pass over device memory, and compiles the
// accumulation of protocol/stark.py `_acc_group` into one program. Run as
// int64 torch ops, a multiply is 47 launches and as many passes, an F_p^3
// multiply about 500, and `_acc_group` materialises (16, N, 3) temporaries.
// These kernels take their place: ops/field.py and ops/xfield.py send a CUDA
// tensor here, protocol/stark.py `_acc_group` sends its group here.
//
// Words are canonical u64 field elements, the bits of the port's int64
// tensors. Every result is the canonical one, equal bit for bit to the
// plain torch version: `f1_add` repeats ops/field.py `add_plain` for any
// 64-bit words, `gl_sub` is `sub_plain` for any, a product is exact before
// its canonical reduction (goldilocks.cuh), so `mul` agrees for any words.
//
// F1, F2 design. What bounds them: bytes. A multiply reads two words and
// writes one, 24 bytes against 18 32-bit instructions; at (2^21,) that is
// 48 MB, 0.0143 ms at 3.35 TB/s, with the operations at 0.0011 ms. One
// thread an element over a grid-stride loop. The operands come as they are,
// broadcast and strided: the wrapper (ops/field_kernels.py) gives the
// broadcast shape with size-1 axes dropped and neighbouring axes merged
// where every operand allows it, and each operand's strides in it (0 on a
// broadcast axis); the kernel splits the element index over at most
// kMaxDims axes, in 32-bit arithmetic when the element count allows it, and
// addresses with 64-bit offsets. So a twiddle row broadcast over a batch,
// a 0-dim constant or a strided column is read where it lies, never copied.
// The output is a new contiguous tensor. F2 takes the stride of each
// operand's coefficient axis besides, so one thread reads its element's
// three coefficients wherever they lie and writes them together.
//
// F3 design. acc[i] += sum_t (w_plain_t + w_shift_t * start_t * ratio_t^i)
// * stack[t, i] over a group of T terms, i in [0, n): each term's column a
// base (n,) or extension (n, 3) run of words wherever it lies (a pointer
// and the strides of its position and coefficient axes, so an LDE's
// columns are read in place and a group needs no concatenation), acc
// (n, 3) contiguous, updated in place. What bounds it on this card: the
// 64-bit multiplies as much as the bytes. An extension term at one
// position is 24 bytes of stack against 12 products of 64-bit words
// (IMAD-family instructions, which issue on half the SM's lanes), a base
// term 8 bytes against 7; and a grid of one fixed tile leaves most of the
// card idle at a streamed class or a small domain. The design:
//   - powers off the chain: a first launch (acc_powers_kernel, one block a
//     term) writes for each term the tables r^j (j < kAccTile), r^(kAccTile
//     m) (m < kAccMid) and start * r^(kAccTile kAccMid h) (h < n / that),
//     each entry one multiply of an earlier entry by a square of r, in
//     rounds that double the filled prefix. A block of the main launch
//     makes w_shift * start * r^(its first position) once a term (two
//     table words, four multiplies, in shared memory), and position i's
//     x^s factor is one table load r^(i mod kAccTile): no thread raises r
//     by square and multiply, no position waits on another's power;
//   - w_shift folded into the block's start, so an extension term's
//     coefficient w_plain + w_shift x^s is 3 multiplies, not 4; a base
//     term's (w_plain + w_shift x^s) y is w_shift (x^s y) + w_plain y, one
//     multiply and 6 products;
//   - lazy reduction: each position's 128-bit products (6 a base term, 9
//     an extension term, which multiplies c by y's 3 x 3 multiplication
//     matrix, X^3 = X - 1 folded into y's entries) are summed over the
//     group's terms unreduced, one sum per coefficient of the result, and
//     reduced once at the end with 2^128 == -2^32 (mod p). A sum keeps the
//     even and the odd 32 x 32 partial products apart (Sum160), so that
//     each multiply-add lands on a 64-bit register pair: a product and its
//     add are 4 wide multiply-adds and 3 carry adds;
//   - a grid for every n: a block is kAccThreads threads, split into G
//     term groups (1, 2, 4, 8) of kAccThreads / G consecutive positions,
//     group g taking terms g, g + G, ...; the groups' sums meet once in
//     shared memory. acc_group_plan picks G from n, T and the kernel's
//     occupancy on this card: the G whose waves of blocks and share of
//     terms a group leave the fewest idle slots (G = 1 wherever the blocks
//     fill the card, a streamed class of 2^17 included; 8 at a domain of
//     2^14). A thread keeps at most 64 registers, so that an SM holds 4
//     blocks (32 warps).
// The power tables, a term's weighting and the lazy sums are
// accumulate.cuh's, which kernel F4 (quotients.cu) shares. Field sums are
// exact, so neither the term split nor the lazy sums change a bit of the
// result.

#include <cstdint>
#include <cuda_runtime.h>

#include "accumulate.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
// F3: threads a block, the most term groups a block and terms a launch,
// the gain a larger term split must bring (acc_group_plan), and the blocks
// an SM must hold (the register cap of acc_group_kernel); the power
// tables' split of a position is accumulate.cuh's
constexpr int kAccLogThreads = 8;
constexpr int kAccThreads = 1 << kAccLogThreads;
constexpr int kAccLogMaxGroups = 3;
constexpr int kAccMaxTerms = 64;
constexpr double kAccSplitGain = 1.05;
constexpr int kAccBlocksPerSm = 4;

enum Op { kAdd = 0, kSub = 1, kMul = 2, kXMul = 3, kXMulBase = 4 };

// The broadcast iteration space: axis sizes and each operand's strides in
// words (0 on a broadcast axis), outermost first; ca, cb the strides of the
// coefficient axis (F2).
struct Layout {
  long long size[kMaxDims];
  long long sa[kMaxDims];
  long long sb[kMaxDims];
  long long ca, cb;
  int ndim;
};

// ops/field.py `add_plain` on u64 words: the wrap of a + b is repaid with
// 2^64 == 2^32 - 1, then p is subtracted once if it fits; canonical for
// canonical words, and the same bits as the plain version for any.
__device__ __forceinline__ uint64_t f1_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += kM32;
  if (s >= kP) s -= kP;
  return s;
}

// offsets of element e in the two operands
template <typename I>
__device__ __forceinline__ void element_offsets(const Layout& L, I e,
                                                long long& oa, long long& ob) {
  long long a = 0, b = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d > 0; --d) {
    if (d < L.ndim) {
      const I n = (I)L.size[d];
      const I q = e / n;
      const I i = e - q * n;
      e = q;
      a += (long long)i * L.sa[d];
      b += (long long)i * L.sb[d];
    }
  }
  oa = a + (long long)e * L.sa[0];
  ob = b + (long long)e * L.sb[0];
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
gl_binary_kernel(int op, const uint64_t* __restrict__ a,
                 const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                 long long total, Layout L) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    long long oa, ob;
    element_offsets<I>(L, (I)i, oa, ob);
    const uint64_t x = a[oa], y = b[ob];
    out[i] = op == kAdd ? f1_add(x, y) : op == kSub ? gl_sub(x, y)
                                                    : gl_mul(x, y);
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
xf_binary_kernel(int op, const uint64_t* __restrict__ a,
                 const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                 long long total, Layout L) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    long long oa, ob;
    element_offsets<I>(L, (I)i, oa, ob);
    const uint64_t a0 = a[oa], a1 = a[oa + L.ca], a2 = a[oa + 2 * L.ca];
    uint64_t r0, r1, r2;
    if (op == kXMul) {
      xf_mul(a0, a1, a2, b[ob], b[ob + L.cb], b[ob + 2 * L.cb], r0, r1, r2);
    } else {
      const uint64_t y = b[ob];
      r0 = gl_mul(a0, y);
      r1 = gl_mul(a1, y);
      r2 = gl_mul(a2, y);
    }
    out[3 * i] = r0;
    out[3 * i + 1] = r1;
    out[3 * i + 2] = r2;
  }
}

// One term of an F3 launch: its column's first word and the strides, in
// words, of its position and coefficient axes (cs unused for a base term).
struct AccTerm {
  const uint64_t* ptr;
  long long is, cs;
};

struct AccArgs {
  uint64_t* acc;            // (n, 3), contiguous
  const uint64_t* w;        // (T, 2, 3): w_plain, w_shift
  const uint64_t* tables;   // (T, row): acc_powers_kernel's
  long long terms, n, row;
  int log_groups;
  AccTerm term[kAccMaxTerms];
};

// F3's tables, block t for term t: row t holds r^j (j < kAccTile), then
// r^(kAccTile m) (m < kAccMid), then start * r^(2^kAccLogTop h) (h < top)
__global__ void __launch_bounds__(kAccThreads)
acc_powers_kernel(const uint64_t* __restrict__ ratios,
                  const uint64_t* __restrict__ starts,
                  uint64_t* __restrict__ tables, long long row,
                  long long top) {
  power_row(ratios[blockIdx.x], starts[blockIdx.x],
            tables + blockIdx.x * row, top);
}

// term c's words at position p: y0, or the three coefficients
template <bool Ext>
__device__ __forceinline__ void load_term(const AccTerm& c, long long p,
                                          uint64_t& y0, uint64_t& y1,
                                          uint64_t& y2) {
  const uint64_t* v = c.ptr + p * c.is;
  y0 = __ldg(v);
  if constexpr (Ext) {
    y1 = __ldg(v + c.cs);
    y2 = __ldg(v + 2 * c.cs);
  }
}

template <bool Ext>
__global__ void __launch_bounds__(kAccThreads, kAccBlocksPerSm)
acc_group_kernel(const __grid_constant__ AccArgs A) {
  // per term: w_shift * start * r^tile0 and w_plain; the term's r^j row
  // from the block's offset in its tile
  __shared__ uint64_t s_w[kAccMaxTerms][6];
  __shared__ const uint64_t* s_pw[kAccMaxTerms];
  __shared__ uint64_t s_red[kAccThreads][3];
  const int lg = A.log_groups;
  const int per = kAccThreads >> lg;  // positions a block
  const int g = threadIdx.x >> (kAccLogThreads - lg);
  const int j = threadIdx.x & (per - 1);
  const long long tile0 = (long long)blockIdx.x * per;
  const long long p = tile0 + j;
  {
    const int off = (int)(tile0 & (kAccTile - 1));
    for (int t = threadIdx.x; t < A.terms; t += kAccThreads) {
      const uint64_t* row = A.tables + t * A.row;
      term_start(row, tile0, A.w + 6 * t, s_w[t]);
      s_pw[t] = row + off;
    }
  }
  __syncthreads();
  const int G = 1 << lg;
  // the sums of the product's three coefficients
  Sum160 s[3] = {};
  if (p < A.n) {
    uint64_t v0 = 0, v1 = 0, v2 = 0;
    if (g < A.terms) load_term<Ext>(A.term[g], p, v0, v1, v2);
    for (int t = g; t < A.terms; t += G) {
      const uint64_t y0 = v0, y1 = v1, y2 = v2;
      // the next term's words in flight while this one multiplies
      if (t + G < A.terms) load_term<Ext>(A.term[t + G], p, v0, v1, v2);
      const uint64_t x = __ldg(s_pw[t] + j);
      if constexpr (Ext)
        acc_ext_term(s, s_w[t], x, y0, y1, y2);
      else
        acc_base_term(s, s_w[t], x, y0);
    }
  }
  uint64_t r0 = reduce160(s[0]), r1 = reduce160(s[1]), r2 = reduce160(s[2]);
  if (lg) {
    if (g) {
      s_red[threadIdx.x][0] = r0;
      s_red[threadIdx.x][1] = r1;
      s_red[threadIdx.x][2] = r2;
    }
    __syncthreads();
    if (g == 0) {
      for (int k = 1; k < G; ++k) {
        const uint64_t* o = s_red[k * per + j];
        r0 = gl_add(r0, o[0]);
        r1 = gl_add(r1, o[1]);
        r2 = gl_add(r2, o[2]);
      }
    }
  }
  if (g == 0 && p < A.n) {
    uint64_t* o = A.acc + 3 * p;
    o[0] = gl_add(o[0], r0);
    o[1] = gl_add(o[1], r1);
    o[2] = gl_add(o[2], r2);
  }
}

int fill_layout(Layout& L, int ndim, const long long* size,
                const long long* sa, const long long* sb) {
  if (ndim < 1 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  L.ndim = ndim;
  for (int d = 0; d < kMaxDims; ++d) {
    L.size[d] = d < ndim ? size[d] : 1;
    L.sa[d] = d < ndim ? sa[d] : 0;
    L.sb[d] = d < ndim ? sb[d] : 0;
  }
  return 0;
}

using BinaryKernel = void (*)(int, const uint64_t*, const uint64_t*,
                              uint64_t*, long long, Layout);

// F1 or F2 with 32-bit element indices where `total` allows them
int launch_binary(BinaryKernel narrow, BinaryKernel wide, int op,
                  const void* a, const void* b, void* out, long long total,
                  const Layout& L, void* stream) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const BinaryKernel kernel = total <= 0xFFFFFFFFLL ? narrow : wide;
  kernel<<<(unsigned int)blocks, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), total, L);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes. Each launches on `stream`, does not synchronise,
// and returns the cudaError_t of the launch (0 = success).

// F1. out[i] = a op b at element i of the broadcast space (op 0 add, 1 sub,
// 2 mul): `ndim` axes of `size`, outermost first, with a's and b's strides
// in words; out contiguous, `total` = the product of the sizes.
extern "C" int gl_binary_launch(int op, const void* a, const void* b,
                                void* out, long long total, int ndim,
                                const long long* size, const long long* sa,
                                const long long* sb, void* stream) {
  if (total <= 0) return 0;
  if (op < kAdd || op > kMul) return (int)cudaErrorInvalidValue;
  Layout L;
  const int rc = fill_layout(L, ndim, size, sa, sb);
  if (rc) return rc;
  L.ca = L.cb = 0;
  return launch_binary(gl_binary_kernel<unsigned int>,
                       gl_binary_kernel<unsigned long long>, op, a, b, out,
                       total, L, stream);
}

// F2. The same over extension elements (op 3 mul, 4 mul_base): `size` and
// the strides describe the elements' axes, ca and cb the stride of each
// operand's coefficient axis (cb unused by mul_base, whose b is a base
// word); out (total, 3) contiguous.
extern "C" int xf_binary_launch(int op, const void* a, const void* b,
                                void* out, long long total, int ndim,
                                const long long* size, const long long* sa,
                                const long long* sb, long long ca,
                                long long cb, void* stream) {
  if (total <= 0) return 0;
  if (op != kXMul && op != kXMulBase) return (int)cudaErrorInvalidValue;
  Layout L;
  const int rc = fill_layout(L, ndim, size, sa, sb);
  if (rc) return rc;
  L.ca = ca;
  L.cb = cb;
  return launch_binary(xf_binary_kernel<unsigned int>,
                       xf_binary_kernel<unsigned long long>, op, a, b, out,
                       total, L, stream);
}

// F3's launch plan, as acc_group_launch makes it: out[0] log2 of the term
// groups a block, out[1] positions a block, out[2] blocks, out[3] blocks
// an SM holds, out[4] SMs, out[5] registers a thread. `log_groups` >= 0
// forces the split (at most log2 of min(T, 8)), -1 leaves it to the rule:
// of G = 1, 2, 4, 8 (G <= T), the one that keeps most of the card's block
// slots busy, blocks / (waves * slots) * T / (G * ceil(T / G)) with slots =
// SMs * blocks an SM holds and waves = ceil(blocks / slots), where a
// larger G must beat the best smaller one by kAccSplitGain: every block
// repeats the terms' starts and its groups meet in shared memory, so a
// split that only trims the last wave of many does not pay.
extern "C" int acc_group_plan(int ext, long long terms, long long n,
                              int log_groups, long long* out) {
  static int sms = 0, occupancy[2] = {0, 0}, regs[2] = {0, 0};
  if (terms <= 0 || terms > kAccMaxTerms || n <= 0 ||
      log_groups > kAccLogMaxGroups)
    return (int)cudaErrorInvalidValue;
  ext = ext ? 1 : 0;
  if (!occupancy[ext]) {
    int dev, rc;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return rc;
    const void* kernel = ext ? (const void*)acc_group_kernel<true>
                             : (const void*)acc_group_kernel<false>;
    cudaFuncAttributes attr;
    if ((rc = (int)cudaFuncGetAttributes(&attr, kernel))) return rc;
    regs[ext] = attr.numRegs;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occupancy[ext], kernel, kAccThreads, 0)))
      return rc;
  }
  const long long slots = (long long)sms * occupancy[ext];
  int best = 0;
  if (log_groups >= 0) {
    if ((1LL << log_groups) > terms) return (int)cudaErrorInvalidValue;
    best = log_groups;
  } else {
    double best_busy = -1.0;
    for (int lg = 0; lg <= kAccLogMaxGroups && (1LL << lg) <= terms; ++lg) {
      const long long per = kAccThreads >> lg, groups = 1LL << lg;
      const long long blocks = (n + per - 1) / per;
      const long long waves = (blocks + slots - 1) / slots;
      const double busy = (double)blocks / (double)(waves * slots) *
                          (double)terms /
                          (double)(groups * ((terms + groups - 1) / groups));
      if (busy > best_busy * kAccSplitGain) {
        best_busy = busy;
        best = lg;
      }
    }
  }
  const long long per = kAccThreads >> best;
  out[0] = best;
  out[1] = per;
  out[2] = (n + per - 1) / per;
  out[3] = occupancy[ext];
  out[4] = sms;
  out[5] = regs[ext];
  return 0;
}

// F3. acc (n, 3) += sum over the T = `terms` terms of (w[t, 0] + w[t, 1] *
// starts[t] * ratios[t]^i) * column_t[i] for i < n, in place. `cols` holds
// T triples (address, position stride, coefficient stride; strides in
// words) on the host: column t's word (i[, k]) lies at address + 8 (i * is
// [+ k * cs]), an extension column (ext = 1) or a base one (ext = 0, cs
// unused). w (T, 2, 3), ratios and starts (T,), all contiguous; `tables`
// device scratch of T * (kAccTile + kAccMid + ceil(n / 2^kAccLogTop))
// words. Two launches: the power tables, then the accumulation, on the
// plan of acc_group_plan (`log_groups` as there). T <= kAccMaxTerms.
extern "C" int acc_group_launch(void* acc, const long long* cols,
                                long long terms, long long n, int ext,
                                const void* w, const void* ratios,
                                const void* starts, void* tables,
                                int log_groups, void* stream) {
  if (terms <= 0 || n <= 0) return 0;
  long long plan[6];
  int rc = acc_group_plan(ext, terms, n, log_groups, plan);
  if (rc) return rc;
  if (plan[2] > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long top = (n + (1LL << kAccLogTop) - 1) >> kAccLogTop;
  AccArgs A;
  A.acc = static_cast<uint64_t*>(acc);
  A.w = static_cast<const uint64_t*>(w);
  A.tables = static_cast<const uint64_t*>(tables);
  A.terms = terms;
  A.n = n;
  A.row = kAccTile + kAccMid + top;
  A.log_groups = (int)plan[0];
  for (long long t = 0; t < terms; ++t) {
    A.term[t].ptr = reinterpret_cast<const uint64_t*>(cols[3 * t]);
    A.term[t].is = cols[3 * t + 1];
    A.term[t].cs = cols[3 * t + 2];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  acc_powers_kernel<<<(unsigned int)terms, kAccThreads, 0, s>>>(
      static_cast<const uint64_t*>(ratios),
      static_cast<const uint64_t*>(starts), static_cast<uint64_t*>(tables),
      A.row, top);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (ext)
    acc_group_kernel<true><<<(unsigned int)plan[2], kAccThreads, 0, s>>>(A);
  else
    acc_group_kernel<false><<<(unsigned int)plan[2], kAccThreads, 0, s>>>(A);
  return (int)cudaGetLastError();
}
