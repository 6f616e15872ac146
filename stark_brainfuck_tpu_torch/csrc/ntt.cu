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
// 2^64 == 2^32 - 1 and 2^96 == -1 (mod p), to the same canonical [0, p)
// result as ops/field.py `reduce128` / `mul`, `add` and `sub`. Proof bytes
// depend on every codeword word, so the kernels never leave a value
// outside [0, p).
//
// B2 design. What bounds it: at the full-size prove (27 rows, FRI 2^21,
// four-step c = 1,024 by r = 2,048) each pass reads and writes the block
// of rows once, 906 MB or 0.27 ms at 3.35 TB/s, and the radix-2 count of
// its adds, subs and multiplies (shifts where the twiddle is a power of
// two) is 0.33-0.37 ms on the integer ALU pipe, which issues 64 lanes a
// clock per SM (the wide multiplies issue on the FMA pipe, 0.02-0.03 ms):
// operations bound it, ahead of the bytes (chip_smoke.py `bound`). With
// the arithmetic cut out the kernel runs at 1.5-1.9x its bytes while with
// the memory traffic cut out it keeps four fifths of its time
// (chip_smoke.py --b2-parts). So the design touches device memory once
// each way, in whole 32-byte sectors, and spends as few instructions as it
// can.
//   - Tile. A block takes 2^log_vo groups of 2^log_ti adjacent vectors of
//     m words. The launcher gives strides (batch, vector, element) for the
//     load and for the store, so the four-step transposes happen in the
//     kernel's own accesses: the column pass reads and writes m x 8 tiles
//     of the (c, r) view (64-byte runs), the row pass reads rows and stores
//     them transposed. Inside a group the adjacent vectors are interleaved
//     (word e holds element e >> log_ti of vector e & (2^log_ti - 1)), so
//     that consecutive threads touch consecutive addresses in both. Short
//     contiguous rows go several to a block (log_vo), a ragged last tile
//     is masked.
//   - Stockham autosort steps of radix 8 (after one of radix 2 or 4 when
//     log m is not a multiple of 3): a thread holds 8 words, does
//     3 stages in registers and writes its outputs where the next step
//     reads them with unit stride. No bit reversal, 1 + log m / 3 steps:
//     the last writes global memory, and between two steps lies one
//     shared-memory round trip with two barriers (4 at m = 8,192, where
//     the radix-2 kernel made 13).
//   - A block walks over tiles (the grid is what the card holds at once).
//     Once a tile's first step has its words in registers, the block's next
//     tile is fetched by cp.async into a staging copy, every thread fetching
//     the words it will itself read, so the copy needs no barrier and runs
//     under the other steps.
//   - Field add and sub are five carry-chained instructions in PTX
//     (`gl_sub`), the reduction of a product two of those; the compiler's
//     own code for the same arithmetic has a 64-bit compare and two selects
//     per correction.
//   - Inside a step every twiddle is an 8th root of unity, a power of 2^24
//     because 2^96 == -1: a shift and the reduction, no wide product. The
//     DFTs use the fixed root 2^24; the plan's sub-root has
//     root^(m/8) = 2^(24 * kappa) for some odd kappa, which only permutes
//     the outputs, so register jr is stored as output jr / kappa mod R.
//   - Between steps output j of butterfly p takes one general multiply by
//     w_n^(p * j), read from the plan's per-step table (rows j, columns p:
//     neighbouring threads read neighbouring words; m words in all, cache
//     resident). The last step has none, and folds `scale` (n^-1 of an
//     inverse plan) into its store.
//   - Shared memory is padded by one word in 16, which spreads the early
//     steps' strided writes over the banks (2-way conflicts at worst).
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

#include "goldilocks.cuh"

namespace {

constexpr int kSubMaxLog = 13;
constexpr int kPerThread = 8;  // words a thread holds in a B2 step

// x * 2^K (mod p) for the shifts of the 8th roots of unity, K = 24, 48, 72:
// the 128-bit product is two shifts, so only the reduction is left.
template <int K>
__device__ __forceinline__ uint64_t gl_mul_pow2(uint64_t x) {
  static_assert(K == 24 || K == 48 || K == 72, "an 8th root's shift");
  if constexpr (K <= 32) {
    // the product is below 2^96: hl * 2^64 + lo with hl = x >> (64 - K)
    const uint64_t hl = x >> (64 - K);
    return gl_sub(x << K, kP - ((hl << 32) - hl));
  } else if constexpr (K < 64) {
    return reduce128(x << K, x >> (64 - K));
  } else {
    // x = xh * 2^24 + xl: xh * 2^96 == -xh, and xl * 2^72 = (xl << 8) * 2^64
  // == (xl << 8) * (2^32 - 1) <= (2^32 - 1)^2 < p
    const uint64_t xl8 = (x & 0xFFFFFFULL) << 8;
    return gl_sub((xl8 << 32) - xl8, x >> 24);
  }
}

// In-register DFTs with the fixed roots 2^24 (order 8), 2^48 (order 4) and
// -1: a[j] becomes sum_k a[k] * (2^24)^(j * k * 8 / R), natural order.
template <int R>
__device__ __forceinline__ void dft_pow2(uint64_t* a);

template <>
__device__ __forceinline__ void dft_pow2<2>(uint64_t* a) {
  const uint64_t s = gl_add(a[0], a[1]);
  a[1] = gl_sub(a[0], a[1]);
  a[0] = s;
}

template <>
__device__ __forceinline__ void dft_pow2<4>(uint64_t* a) {
  const uint64_t e0 = gl_add(a[0], a[2]);
  const uint64_t e1 = gl_add(a[1], a[3]);
  const uint64_t f0 = gl_sub(a[0], a[2]);
  const uint64_t f1 = gl_mul_pow2<48>(gl_sub(a[1], a[3]));
  a[0] = gl_add(e0, e1);
  a[1] = gl_add(f0, f1);
  a[2] = gl_sub(e0, e1);
  a[3] = gl_sub(f0, f1);
}

template <>
__device__ __forceinline__ void dft_pow2<8>(uint64_t* a) {
  uint64_t u[4], v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) u[k] = gl_add(a[k], a[k + 4]);
  v[0] = gl_sub(a[0], a[4]);
  v[1] = gl_mul_pow2<24>(gl_sub(a[1], a[5]));
  v[2] = gl_mul_pow2<48>(gl_sub(a[2], a[6]));
  v[3] = gl_mul_pow2<72>(gl_sub(a[3], a[7]));
  dft_pow2<4>(u);  // even outputs
  dft_pow2<4>(v);  // odd outputs
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[2 * k] = u[k];
    a[2 * k + 1] = v[k];
  }
}

struct SubnttArgs {
  const uint64_t* x;
  uint64_t* y;
  const uint64_t* tab;
  long long nvec, tiles_per_batch, tiles;
  long long in_bs, in_vs, in_es, out_bs, out_vs, out_es;
  uint64_t scale;
  int log_m, log_ti, log_vo, kinv;
};

// one spare word in 17: the first exchanges write at strides of 2, 4 or 8
// words, which would otherwise fall into one or two banks
__device__ __forceinline__ int sm_pad(int a) { return a + (a >> 4); }

// 8 bytes from global to shared memory without passing through registers;
// `valid` false writes zero and reads nothing
__device__ __forceinline__ void copy_async8(uint64_t* dst, const uint64_t* src,
                                            bool valid) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(to), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  long long in0, out0, vec0;  // the batch's offsets, the tile's first vector
};

__device__ __forceinline__ Tile tile_of(const SubnttArgs& A, long long t) {
  const long long batch = t / A.tiles_per_batch;
  const long long tile = t - batch * A.tiles_per_batch;
  return {batch * A.in_bs, batch * A.out_bs, tile << (A.log_ti + A.log_vo)};
}

// Starts the copy of tile t into `stage`, for a first step of radix R:
// every thread fetches the 8 words that it will itself read there (word
// i + k * M / R of its butterflies), so no barrier stands between the copy
// and the step, only the thread's own wait.
template <int R>
__device__ __forceinline__ void prefetch_tile(const SubnttArgs& A,
                                              uint64_t* stage, long long t) {
  constexpr int LR = R == 8 ? 3 : R == 4 ? 2 : 1;
  const Tile T = tile_of(A, t);
  const int log_M = A.log_m + A.log_ti;
  const int log_bf = log_M - LR;
#pragma unroll
  for (int g = 0; g < kPerThread / R; ++g) {
    const int u = threadIdx.x + g * blockDim.x;
    const int vo = u >> log_bf;
    const int i = u & ((1 << log_bf) - 1);
    // k << log_bf leaves the low log_ti bits alone (log_bf >= log_ti): the
    // vector is the same for every k, the element moves by a stride
    const long long vec =
        T.vec0 + (vo << A.log_ti) + (i & ((1 << A.log_ti) - 1));
    const bool valid = vec < A.nvec;
    const uint64_t* src =
        valid ? A.x + T.in0 + vec * A.in_vs + (long long)(i >> A.log_ti) * A.in_es
              : A.x;
    const long long k_stride = valid ? A.in_es << (log_bf - A.log_ti) : 0;
    uint64_t* dst = stage + (vo << log_M) + i;
#pragma unroll
    for (int k = 0; k < R; ++k)
      copy_async8(dst + (k << log_bf), src + k * k_stride, valid);
  }
  copy_async_commit();
}

// One Stockham step of radix R on the block's tile: every thread takes
// 8 / R butterflies. Butterfly i of a group reads the R words
// i + k * M / R (from the staged copy of the tile in the FIRST step, else
// from the exchange buffer), and with q = i mod s, p = i / s its output j,
// times root^((m / n) * p * j) from the step's table, goes to
// q + s * (R * p + j) (to global memory in the LAST step, where p = 0). A
// FIRST step, once its words are in registers, starts the copy of the
// block's next tile, which then arrives during the other steps.
template <int R, bool FIRST, bool LAST>
__device__ __forceinline__ void subntt_step(const SubnttArgs& A,
                                            uint64_t* stage, uint64_t* sm,
                                            const Tile& T, long long next,
                                            int log_n, int log_s,
                                            int tab_off) {
  constexpr int LR = R == 8 ? 3 : R == 4 ? 2 : 1;
  constexpr int G = kPerThread / R;
  const int log_M = A.log_m + A.log_ti;
  const int log_bf = log_M - LR;
  const int bf_mask = (1 << log_bf) - 1;
  const int ti_mask = (1 << A.log_ti) - 1;
  uint64_t a[kPerThread];
  if (FIRST) copy_async_wait();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int u = threadIdx.x + g * blockDim.x;
    const int e = ((u >> log_bf) << log_M) + (u & bf_mask);
#pragma unroll
    for (int k = 0; k < R; ++k)
      a[g * R + k] =
          FIRST ? stage[e + (k << log_bf)] : sm[sm_pad(e + (k << log_bf))];
  }
  if (!FIRST) __syncthreads();  // every thread has read its words
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dft_pow2<R>(a + g * R);
    const int u = threadIdx.x + g * blockDim.x;
    const int vo = u >> log_bf;
    const int i = u & bf_mask;
    const int q = i & ((1 << log_s) - 1);
    const int p = i >> log_s;
    // LAST: p = 0 and log_s >= log_ti, so output j lies j strides past
    // output 0 of the same vector
    const long long vec = T.vec0 + (vo << A.log_ti) + (q & ti_mask);
    uint64_t* dst = A.y + T.out0 + vec * A.out_vs +
                    (long long)(q >> A.log_ti) * A.out_es;
    const long long j_stride = A.out_es << (log_s - A.log_ti);
    const uint64_t* tw = A.tab + tab_off + p;
#pragma unroll
    for (int jr = 0; jr < R; ++jr) {
      // the sub-root's R-th root is (2^24)^(kappa * 8 / R): register jr
      // holds the true output j = jr / kappa (mod R); the table's rows are
      // in register order
      const int j = (A.kinv * jr) & (R - 1);
      uint64_t b = a[g * R + jr];
      if (!LAST && jr != 0) b = gl_mul(b, __ldg(tw + ((jr - 1) << (log_n - LR))));
      if (LAST) {
        if (A.scale != 1) b = gl_mul(b, A.scale);
        if (vec < A.nvec) dst[j * j_stride] = b;
      } else {
        sm[sm_pad((vo << log_M) + q + ((p * R + j) << log_s))] = b;
      }
    }
  }
  if (FIRST && next < A.tiles) prefetch_tile<R>(A, stage, next);
  if (!LAST) __syncthreads();
}

template <int R>
__device__ __forceinline__ void subntt_step_any(const SubnttArgs& A,
                                                uint64_t* stage, uint64_t* sm,
                                                const Tile& T, long long next,
                                                int log_n, int log_s,
                                                int tab_off, bool first,
                                                bool last) {
  if (first && last)
    subntt_step<R, true, true>(A, stage, sm, T, next, log_n, log_s, tab_off);
  else if (first)
    subntt_step<R, true, false>(A, stage, sm, T, next, log_n, log_s, tab_off);
  else if (last)
    subntt_step<R, false, true>(A, stage, sm, T, next, log_n, log_s, tab_off);
  else
    subntt_step<R, false, false>(A, stage, sm, T, next, log_n, log_s, tab_off);
}

// Shared memory: the staged copy of a tile (2^log_e words), then the
// padded exchange buffer. A block walks over tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
__global__ void __launch_bounds__(1024) subntt_kernel(const SubnttArgs A) {
  extern __shared__ uint64_t shared[];
  uint64_t* stage = shared;
  uint64_t* sm = shared + (1 << (A.log_m + A.log_ti + A.log_vo));
  const int rem = A.log_m % 3;
  const int n8 = A.log_m / 3;
  if (rem == 1)
    prefetch_tile<2>(A, stage, blockIdx.x);
  else if (rem == 2)
    prefetch_tile<4>(A, stage, blockIdx.x);
  else
    prefetch_tile<8>(A, stage, blockIdx.x);
  for (long long t = blockIdx.x; t < A.tiles; t += gridDim.x) {
    const Tile T = tile_of(A, t);
    const long long next = t + gridDim.x;
    int log_n = A.log_m, log_s = A.log_ti, tab_off = 0;
    if (rem == 1) {
      subntt_step_any<2>(A, stage, sm, T, next, log_n, log_s, tab_off, true,
                         n8 == 0);
      tab_off += 1 << (log_n - 1);
    } else if (rem == 2) {
      subntt_step_any<4>(A, stage, sm, T, next, log_n, log_s, tab_off, true,
                         n8 == 0);
      tab_off += 3 << (log_n - 2);
    }
    log_n -= rem;
    log_s += rem;
    for (int s8 = 0; s8 < n8; ++s8) {
      subntt_step_any<8>(A, stage, sm, T, next, log_n, log_s, tab_off,
                         rem == 0 && s8 == 0, s8 == n8 - 1);
      tab_off += 7 << (log_n - 3);
      log_n -= 3;
      log_s += 3;
    }
    // the last step wrote no shared memory, and the next tile's first step
    // reads only the thread's own staged words and ends in a barrier
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

// B2. `batches` x `nvec` vectors of m = 2^log_m canonical words: element i
// of vector v of batch b is x[b * in_bs + v * in_vs + i * in_es], and its
// transform, times `scale` (1 = none), goes to the same place of y under
// the out strides (all in words). A block takes 2^log_vo groups of 2^log_ti
// adjacent vectors, 8 words a thread, so at most 2^13 words. tab: the between-step
// twiddles of the plan (ops/kernel_ntt.py `step_table`), kinv: the inverse
// mod 8 of the kappa with root^(m/8) = 2^(24 * kappa). x and y may not
// overlap.
extern "C" int subntt_launch(const void* x, void* y, const void* tab,
                             long long batches, long long nvec, int log_m,
                             int log_ti, int log_vo, int kinv,
                             unsigned long long scale, long long in_bs,
                             long long in_vs, long long in_es,
                             long long out_bs, long long out_vs,
                             long long out_es, void* stream) {
  if (batches <= 0 || nvec <= 0) return 0;
  const int log_e = log_m + log_ti + log_vo;
  if (log_m < 1 || log_m > kSubMaxLog || log_ti < 0 || log_vo < 0 ||
      log_e < 6 || log_e > 13 || !(kinv & 1))
    return (int)cudaErrorInvalidValue;
  const int threads = (1 << log_e) / kPerThread;
  const long long per_tile = 1LL << (log_ti + log_vo);
  const long long tiles = (nvec + per_tile - 1) / per_tile;
  if (tiles > 0x7FFFFFFFLL / batches) return (int)cudaErrorInvalidValue;
  const int words = (2 << log_e) + (1 << (log_e - 4)) + 1;
  const int smem = (int)(sizeof(uint64_t) * words);
  cudaError_t err = cudaFuncSetAttribute(
      subntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the card holds at once, each walking over tiles
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subntt_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  const long long total = batches * tiles;
  SubnttArgs A;
  A.x = static_cast<const uint64_t*>(x);
  A.y = static_cast<uint64_t*>(y);
  A.tab = static_cast<const uint64_t*>(tab);
  A.nvec = nvec;
  A.tiles_per_batch = tiles;
  A.tiles = total;
  A.in_bs = in_bs;
  A.in_vs = in_vs;
  A.in_es = in_es;
  A.out_bs = out_bs;
  A.out_vs = out_vs;
  A.out_es = out_es;
  A.scale = (uint64_t)scale;
  A.log_m = log_m;
  A.log_ti = log_ti;
  A.log_vo = log_vo;
  A.kinv = kinv & 7;
  subntt_kernel<<<(unsigned int)(total < resident ? total : resident), threads,
                  smem, static_cast<cudaStream_t>(stream)>>>(A);
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
