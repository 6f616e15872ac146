// BLAKE2b-512 over a batch of equal-length messages, for Hopper (sm_90a).
//
// Replaces the TPU kernel B1: stark_brainfuck_tpu/ops/pallas_blake2b.py,
// blake2b_words_pallas (kernel body _kernel_body), which kept the state as
// u32 limb pairs in VMEM because the TPU has no 64-bit integer unit.
//
// What bounds it on this card: operations. One compression is 12 rounds of
// 8 G-functions; each G is 4 three-input 64-bit adds, 4 xors and 4
// rotates, which the SM runs as 32-bit integer instructions (an add is 2
// IADD3 with a carry, a xor 2 LOP3, a rotate by 24/16/63 2 funnel shifts,
// the rotate by 32 a free half swap): at least 96 * 22 + 16 = 2,128
// instructions per 128-byte block against at most 128 + 64 bytes of
// device traffic. All of them issue on the integer ALU pipe (132 SMs x 64
// lanes x 1.98 GHz, ~16.7 T instr/s); against 3.35 TB/s they take about
// 2.2x the time of the bytes for a one-block leaf, so the kernel is bound
// by operations.
//
// Design (simple and correct first): one thread per message, 128-thread
// blocks, a ragged tail masked. The state v[16], the chaining value h[8]
// and the current block m[16] live in registers as uint64_t; the 12 rounds
// are written out with literal SIGMA indices, so every message index is a
// compile-time constant and m[] never goes to local memory. W (words per
// message, a multiple of 16) and msg_len are runtime arguments; the byte
// counter t and the last-block flag follow BLAKE2b (RFC 7693). Input is
// (n, W) row-major 64-bit words, read 16 bytes at a time; output is (n, 8).
// Coalesced staging through shared memory, a fused multi-level Merkle
// kernel and a persistent grid are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
  return (x >> r) | (x << (64 - r));
}

#define B2B_G(a, b, c, d, x, y)          \
  do {                                   \
    v[a] = v[a] + v[b] + (x);            \
    v[d] = rotr64(v[d] ^ v[a], 32);      \
    v[c] = v[c] + v[d];                  \
    v[b] = rotr64(v[b] ^ v[c], 24);      \
    v[a] = v[a] + v[b] + (y);            \
    v[d] = rotr64(v[d] ^ v[a], 16);      \
    v[c] = v[c] + v[d];                  \
    v[b] = rotr64(v[b] ^ v[c], 63);      \
  } while (0)

#define B2B_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12,   \
                  s13, s14, s15)                                          \
  do {                                                                    \
    B2B_G(0, 4, 8, 12, m[s0], m[s1]);                                     \
    B2B_G(1, 5, 9, 13, m[s2], m[s3]);                                     \
    B2B_G(2, 6, 10, 14, m[s4], m[s5]);                                    \
    B2B_G(3, 7, 11, 15, m[s6], m[s7]);                                    \
    B2B_G(0, 5, 10, 15, m[s8], m[s9]);                                    \
    B2B_G(1, 6, 11, 12, m[s10], m[s11]);                                  \
    B2B_G(2, 7, 8, 13, m[s12], m[s13]);                                   \
    B2B_G(3, 4, 9, 14, m[s14], m[s15]);                                   \
  } while (0)

__constant__ uint64_t kIV[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL,
};

__device__ __forceinline__ void compress(uint64_t h[8], const uint64_t m[16],
                                         uint64_t t, bool last) {
  uint64_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kIV[i];
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2B_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2B_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2B_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2B_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2B_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2B_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2B_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2B_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

__global__ void __launch_bounds__(128)
blake2b_words_kernel(const uint64_t* __restrict__ msg,
                     uint64_t* __restrict__ out, long long n, int W,
                     int msg_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = kIV[j];
  // parameter block: digest_size=64, key length 0, fanout 1, depth 1
  h[0] ^= 0x01010040ULL;

  const ulonglong2* row =
      reinterpret_cast<const ulonglong2*>(msg + (size_t)i * (size_t)W);
  const int nblocks = W / 16;
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t m[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const ulonglong2 pair = row[blk * 8 + j];
      m[2 * j] = pair.x;
      m[2 * j + 1] = pair.y;
    }
    const bool last = blk == nblocks - 1;
    const uint64_t t = last ? (uint64_t)msg_len : (uint64_t)(blk + 1) * 128u;
    compress(h, m, t, last);
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + (size_t)i * 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = make_ulonglong2(h[2 * j], h[2 * j + 1]);
}

}  // namespace

// C entry for ctypes. msg: (n, W) uint64 row-major, W % 16 == 0, 16-byte
// aligned; out: (n, 8) uint64. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() of the launch (0 = success).
extern "C" int blake2b_words_launch(const void* msg, void* out, long long n,
                                    int W, int msg_len, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  blake2b_words_kernel<<<(unsigned int)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(msg), static_cast<uint64_t*>(out), n, W,
      msg_len);
  return (int)cudaGetLastError();
}
