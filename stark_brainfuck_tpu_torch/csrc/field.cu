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
// * stack[t, i] over a group of T terms, i in [0, n): stack (T, n) base or
// (T, n, 3) extension words at any strides, acc (n, 3) contiguous, updated
// in place. What bounds it: on paper both, about equally. A base term
// costs 7 multiplies and 6 adds an element, an extension term 13 and 14,
// against 8 or 24 bytes of stack; acc is read and written once a launch.
// So the kernel reads each stack word once, never writes a temporary, and
// generates x^s = start * ratio^i itself: a block owns kAccRun runs of
// kAccThreads consecutive positions, thread j the positions
// tile + j + k * kAccThreads (neighbouring threads on neighbouring words),
// with the T sums of its kAccRun positions in registers. For each term it
// raises ratio to its first position by square and multiply, its own bits
// (kAccLogThreads of them, whose last square is the step ratio^kAccThreads)
// and then the block's, and steps by one multiply a position. A field sum
// is exact, so the order over terms does not change a bit of the result.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr int kAccLogThreads = 7;
constexpr int kAccThreads = 1 << kAccLogThreads;
constexpr int kAccLogRun = 3;
constexpr int kAccRun = 1 << kAccLogRun;

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

// F_p^3 product, schoolbook then X^3 = X - 1 and X^4 = X^2 - X, in the
// order of ops/xfield.py `mul_plain`
__device__ __forceinline__ void xf_mul(uint64_t a0, uint64_t a1, uint64_t a2,
                                       uint64_t b0, uint64_t b1, uint64_t b2,
                                       uint64_t& r0, uint64_t& r1,
                                       uint64_t& r2) {
  const uint64_t c0 = gl_mul(a0, b0);
  const uint64_t c1 = gl_add(gl_mul(a0, b1), gl_mul(a1, b0));
  const uint64_t c2 =
      gl_add(gl_add(gl_mul(a0, b2), gl_mul(a1, b1)), gl_mul(a2, b0));
  const uint64_t c3 = gl_add(gl_mul(a1, b2), gl_mul(a2, b1));
  const uint64_t c4 = gl_mul(a2, b2);
  r0 = gl_sub(c0, c3);
  r1 = gl_sub(gl_add(c1, c3), c4);
  r2 = gl_add(c2, c4);
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

struct AccArgs {
  uint64_t* acc;           // (n, 3), contiguous
  const uint64_t* stack;   // (T, n) or (T, n, 3) at strides ts, is, cs
  const uint64_t* w;       // (T, 2, 3): w_plain, w_shift
  const uint64_t* ratios;  // (T,)
  const uint64_t* starts;  // (T,)
  long long terms, n, ts, is, cs;
};

template <bool Ext>
__global__ void __launch_bounds__(kAccThreads) acc_group_kernel(AccArgs A) {
  const long long tile = (long long)blockIdx.x << (kAccLogThreads + kAccLogRun);
  const long long p0 = tile + threadIdx.x;
  uint64_t s[kAccRun][3];
#pragma unroll
  for (int k = 0; k < kAccRun; ++k) s[k][0] = s[k][1] = s[k][2] = 0;
  for (long long t = 0; t < A.terms; ++t) {
    // x = start * ratio^p0: the thread's bits, then the block's
    uint64_t x = A.starts[t], b = A.ratios[t];
#pragma unroll
    for (int k = 0; k < kAccLogThreads; ++k) {
      if ((threadIdx.x >> k) & 1) x = gl_mul(x, b);
      b = gl_mul(b, b);
    }
    const uint64_t step = b;  // ratio^kAccThreads
#pragma unroll
    for (int k = 0; k < kAccLogRun; ++k) b = gl_mul(b, b);
    for (unsigned int e = blockIdx.x; e; e >>= 1) {
      if (e & 1) x = gl_mul(x, b);
      if (e > 1) b = gl_mul(b, b);
    }
    const uint64_t* w = A.w + 6 * t;
    const uint64_t wp0 = w[0], wp1 = w[1], wp2 = w[2];
    const uint64_t ws0 = w[3], ws1 = w[4], ws2 = w[5];
    const uint64_t* st = A.stack + t * A.ts;
#pragma unroll
    for (int k = 0; k < kAccRun; ++k) {
      const long long p = p0 + k * kAccThreads;
      if (p < A.n) {
        const uint64_t c0 = gl_add(gl_mul(ws0, x), wp0);
        const uint64_t c1 = gl_add(gl_mul(ws1, x), wp1);
        const uint64_t c2 = gl_add(gl_mul(ws2, x), wp2);
        const uint64_t* v = st + p * A.is;
        uint64_t r0, r1, r2;
        if constexpr (Ext) {
          xf_mul(c0, c1, c2, v[0], v[A.cs], v[2 * A.cs], r0, r1, r2);
        } else {
          const uint64_t y = v[0];
          r0 = gl_mul(c0, y);
          r1 = gl_mul(c1, y);
          r2 = gl_mul(c2, y);
        }
        s[k][0] = gl_add(s[k][0], r0);
        s[k][1] = gl_add(s[k][1], r1);
        s[k][2] = gl_add(s[k][2], r2);
      }
      if (k + 1 < kAccRun) x = gl_mul(x, step);
    }
  }
#pragma unroll
  for (int k = 0; k < kAccRun; ++k) {
    const long long p = p0 + k * kAccThreads;
    if (p < A.n) {
      uint64_t* o = A.acc + 3 * p;
      o[0] = gl_add(o[0], s[k][0]);
      o[1] = gl_add(o[1], s[k][1]);
      o[2] = gl_add(o[2], s[k][2]);
    }
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

// F3. acc (n, 3) += sum over the T = `terms` terms of (w[t, 0] + w[t, 1] *
// starts[t] * ratios[t]^i) * stack[t, i] for i < n, in place. stack word
// (t, i[, k]) at t * ts + i * is (+ k * cs) for an extension stack
// (ext = 1), a base stack (ext = 0) ignores cs; w (T, 2, 3), ratios and
// starts (T,), all contiguous.
extern "C" int acc_group_launch(void* acc, const void* stack, const void* w,
                                const void* ratios, const void* starts,
                                long long terms, long long n, long long ts,
                                long long is, long long cs, int ext,
                                void* stream) {
  if (terms <= 0 || n <= 0) return 0;
  const long long per_block = (long long)kAccThreads * kAccRun;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  AccArgs A;
  A.acc = static_cast<uint64_t*>(acc);
  A.stack = static_cast<const uint64_t*>(stack);
  A.w = static_cast<const uint64_t*>(w);
  A.ratios = static_cast<const uint64_t*>(ratios);
  A.starts = static_cast<const uint64_t*>(starts);
  A.terms = terms;
  A.n = n;
  A.ts = ts;
  A.is = is;
  A.cs = cs;
  const auto s = static_cast<cudaStream_t>(stream);
  if (ext)
    acc_group_kernel<true><<<(unsigned int)blocks, kAccThreads, 0, s>>>(A);
  else
    acc_group_kernel<false><<<(unsigned int)blocks, kAccThreads, 0, s>>>(A);
  return (int)cudaGetLastError();
}
