// Goldilocks NTT kernels for Hopper (sm_90a): the sub-NTT (B2) and the
// four-step outer twiddle (B3) of the port's `ntt_backend="mxu"` path.
//
// Replaces two TPU kernels of stark_brainfuck_tpu/ops/pallas_ntt.py:
//
//   B2  _subntt_call        a full NTT of <= 2^13 points along each row,
//   B3  _twiddle_outer_call row g, column j times w^((g mod c) * j).
//
// The TPU kernels hold each field element as 9 balanced int8 limbs so the
// DFTs run as int8 matrix products on the MXU, with 17 int32 diagonals
// folded back after every product. Hopper multiplies 64-bit words natively
// (a * b and __umul64hi), so these kernels take the canonical u64 words
// (the port's int64 tensors) directly and compute the same transform.
//
// Field: p = 2^64 - 2^32 + 1. A product hi * 2^64 + lo is reduced with
// 2^64 == 2^32 - 1 and 2^96 == -1 (mod p), in the same steps and with the
// same canonical [0, p) result as ops/field.py `reduce128` / `mul`; add and
// sub follow `add` / `sub`. Proof bytes depend on every codeword word, so
// the kernels never leave a value outside [0, p).
//
// B2 design (simple and correct first): one block per row. The row
// (m = 2^log_m <= 8192 words, 64 KB at the top, above the 48 KB default,
// hence cudaFuncSetAttribute) is loaded into dynamic shared memory in
// bit-reversed order (__brev), then log_m radix-2 Cooley-Tukey stages run
// with __syncthreads() between them, each thread taking butterflies
// k, k + blockDim.x, ...; stage s (block 2h) reads w_{2h}^j = w^(j * m / 2h)
// from the plan's table of the m/2 powers of the sub-root in global
// memory (a few KB, L1/L2 resident). The row is stored in natural order,
// times `scale` when the plan folds n^-1 of an inverse transform into its
// last sub-NTT. What bounds it: at the full-size prove (27 rows, FRI 2^21,
// four-step r = 8192, c = 256) the r-pass moves 6,912 rows x 8,192 words
// in and out, 906 MB or 0.27 ms at 3.35 TB/s. Its 6,912 x 4,096 x 13
// butterflies each add and sub, but 8,191 per row multiply by 1 and 20,449
// by a power of two (the 64th roots of unity), which needs no wide product:
// about 8.2 G 32-bit integer instructions at least, 0.24 ms at the SM issue
// ceiling. So bytes bound it. Several rows per block, a radix-4/8 register
// network and fusing the four-step transposes into the loads and stores
// are later work.
//
// B3 design: one thread per element over a grid-stride loop, 64-bit
// indices (rows * r reaches 27 * 2^26). Element (g, j) is multiplied by
// tw_lo[b & 127, j] then by tw_hi[b >> 7, j] with b = g mod c: the (c, r)
// table w^(b * j) factored as w^(b_lo * j) * w^(128 * b_hi * j), as the TPU
// kernel does, so it stays (128 + c/128) * r words. Out of place. What
// bounds it: bytes, 16 per element (read y, write out) against two field
// multiplies; 906 MB or 0.27 ms at the full-size shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ULL;
constexpr uint64_t kM32 = 0xFFFFFFFFULL;  // 2^64 - p == 2^32 - 1
constexpr int kSubMaxLog = 13;

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += kM32;  // wrapped: s + 2^64 == s + (2^32 - 1)
  if (s >= kP) s -= kP;
  return s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - kM32 : d;  // borrowed: d - 2^64 + p
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & kM32;
  // lo - hh * 2^96 == lo - hh (mod p); hh < 2^32 so one correction
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= kM32;
  // hl * 2^64 == hl * (2^32 - 1) < 2^64
  const uint64_t t1 = hl * kM32;
  uint64_t r = t0 + t1;
  if (r < t1) r += kM32;
  if (r >= kP) r -= kP;
  return r;
}

__global__ void subntt_kernel(const uint64_t* __restrict__ x,
                              uint64_t* __restrict__ y,
                              const uint64_t* __restrict__ tw, int log_m,
                              uint64_t scale) {
  extern __shared__ uint64_t s[];
  const int m = 1 << log_m;
  const size_t base = (size_t)blockIdx.x << log_m;
  const uint64_t* row = x + base;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int j = log_m ? (int)(__brev((unsigned)i) >> (32 - log_m)) : 0;
    s[j] = row[i];
  }
  __syncthreads();
  const int half_m = m >> 1;
  for (int lh = 0; lh < log_m; ++lh) {
    const int half = 1 << lh;
    const int tw_shift = log_m - 1 - lh;  // w_{2h}^j = w^(j << tw_shift)
    for (int k = threadIdx.x; k < half_m; k += blockDim.x) {
      const int j = k & (half - 1);
      const int i0 = ((k >> lh) << (lh + 1)) + j;
      const int i1 = i0 + half;
      const uint64_t t = gl_mul(s[i1], tw[j << tw_shift]);
      const uint64_t u = s[i0];
      s[i0] = gl_add(u, t);
      s[i1] = gl_sub(u, t);
    }
    __syncthreads();
  }
  uint64_t* out = y + base;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const uint64_t v = s[i];
    out[i] = scale == 1 ? v : gl_mul(v, scale);
  }
}

__global__ void __launch_bounds__(256)
twiddle_outer_kernel(const uint64_t* __restrict__ y, uint64_t* __restrict__ out,
                     const uint64_t* __restrict__ tw_hi,
                     const uint64_t* __restrict__ tw_lo, long long total,
                     int log_r, int log_c) {
  const long long r_mask = (1LL << log_r) - 1;
  const long long c_mask = (1LL << log_c) - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long j = i & r_mask;
    const long long b = (i >> log_r) & c_mask;
    const uint64_t lo = tw_lo[((b & 127) << log_r) | j];
    const uint64_t hi = tw_hi[((b >> 7) << log_r) | j];
    out[i] = gl_mul(gl_mul(y[i], lo), hi);
  }
}

}  // namespace

// C entries for ctypes. Each launches on `stream`, does not synchronise,
// and returns the cudaError_t of the launch (0 = success).

// x, y: (rows, 2^log_m) uint64 row-major, canonical; tw: the 2^(log_m-1)
// powers of the sub-root (at least one word); y = NTT of each row of x,
// times `scale` (1 = none). x and y may not overlap.
extern "C" int subntt_launch(const void* x, void* y, const void* tw,
                             long long rows, int log_m,
                             unsigned long long scale, void* stream) {
  if (rows <= 0) return 0;
  if (log_m < 0 || log_m > kSubMaxLog || rows > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(uint64_t) << log_m);
  const cudaError_t attr = cudaFuncSetAttribute(
      subntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int threads = (1 << log_m) / 2;
  threads = threads < 32 ? 32 : threads > 512 ? 512 : threads;
  subntt_kernel<<<(unsigned int)rows, threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tw), log_m, (uint64_t)scale);
  return (int)cudaGetLastError();
}

// y, out: (rows, 2^log_r) uint64 row-major, rows a multiple of
// c = 2^log_c >= 128; tw_hi: (c / 128, r), tw_lo: (128, r).
// out[g, j] = y[g, j] * w^((g mod c) * j).
extern "C" int twiddle_outer_launch(const void* y, void* out,
                                    const void* tw_hi, const void* tw_lo,
                                    long long rows, int log_r, int log_c,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (log_r < 0 || log_r > kSubMaxLog || log_c < 7 || log_c > kSubMaxLog)
    return (int)cudaErrorInvalidValue;
  const long long total = rows << log_r;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  twiddle_outer_kernel<<<(unsigned int)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(y), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(tw_hi), static_cast<const uint64_t*>(tw_lo),
      total, log_r, log_c);
  return (int)cudaGetLastError();
}
