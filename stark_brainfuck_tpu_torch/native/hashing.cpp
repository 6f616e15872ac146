// Native hashing engine: BLAKE2b-512 + parallel Merkle tree construction
// (the port's copy of the JAX package's engine, cut to the one entry point
// the port calls).
//
// The commitment phase hashes O(N) leaves plus O(N) internal nodes per tree
// (ref merkle.py:29-42); in pure python this dominates the host trees'
// wall time. This module implements BLAKE2b from the RFC 7693
// specification and builds whole trees over contiguous leaf buffers with
// OpenMP across rows and levels.
//
// Exposed C ABI (ctypes):
//   merkle_from_payloads(payloads, len, count, nodes)
//                                              - leaves + tree in one call

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

constexpr uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

inline uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64 - n));
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/ARM)
}

inline void store64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

struct Blake2bState {
  uint64_t h[8];
  uint64_t t0;
};

inline void g_mix(uint64_t* v, int a, int b, int c, int d, uint64_t x,
                  uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

void compress(Blake2bState& s, const uint8_t* block, bool last) {
  uint64_t m[16];
  for (int i = 0; i < 16; i++) m[i] = load64(block + 8 * i);
  uint64_t v[16];
  for (int i = 0; i < 8; i++) v[i] = s.h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = IV[i];
  v[12] ^= s.t0;
  // t1 (high counter word) stays 0 for < 2^64-byte inputs
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; r++) {
    const uint8_t* sg = SIGMA[r];
    g_mix(v, 0, 4, 8, 12, m[sg[0]], m[sg[1]]);
    g_mix(v, 1, 5, 9, 13, m[sg[2]], m[sg[3]]);
    g_mix(v, 2, 6, 10, 14, m[sg[4]], m[sg[5]]);
    g_mix(v, 3, 7, 11, 15, m[sg[6]], m[sg[7]]);
    g_mix(v, 0, 5, 10, 15, m[sg[8]], m[sg[9]]);
    g_mix(v, 1, 6, 11, 12, m[sg[10]], m[sg[11]]);
    g_mix(v, 2, 7, 8, 13, m[sg[12]], m[sg[13]]);
    g_mix(v, 3, 4, 9, 14, m[sg[14]], m[sg[15]]);
  }
  for (int i = 0; i < 8; i++) s.h[i] ^= v[i] ^ v[8 + i];
}

void blake2b_512(const uint8_t* in, size_t len, uint8_t* out64) {
  Blake2bState s;
  for (int i = 0; i < 8; i++) s.h[i] = IV[i];
  s.h[0] ^= 0x01010040ULL;  // digest_length=64, fanout=1, depth=1
  s.t0 = 0;
  uint8_t block[128];
  if (len > 128) {
    size_t full = (len - 1) / 128;  // all but the final (possibly full) block
    for (size_t b = 0; b < full; b++) {
      s.t0 += 128;
      compress(s, in + 128 * b, false);
    }
    size_t rem = len - 128 * full;
    std::memset(block, 0, 128);
    std::memcpy(block, in + 128 * full, rem);
    s.t0 += rem;
    compress(s, block, true);
  } else {
    std::memset(block, 0, 128);
    std::memcpy(block, in, len);
    s.t0 = len;
    compress(s, block, true);
  }
  for (int i = 0; i < 8; i++) store64(out64 + 8 * i, s.h[i]);
}

// Rows below this count hash on the calling thread: a parallel region's
// start and barrier cost more than the hashes (about 0.5 us each) of a
// small level, and a tree has one region per level. On an 8-CPU host,
// trees of 2^10 to 2^16 leaves built fastest with 256 here (chip_smoke.py's
// parallel_min_sweep); a build may set it with -DMERKLE_PARALLEL_MIN=<rows>.
#ifndef MERKLE_PARALLEL_MIN
#define MERKLE_PARALLEL_MIN 256
#endif
constexpr long long kParallelMin = MERKLE_PARALLEL_MIN;

}  // namespace

extern "C" {

// nodes: buffer of 2*count 64-byte slots; node k's children are 2k, 2k+1;
// leaves occupy slots [count, 2*count); slot 1 is the root (heap layout,
// matching ref merkle.py:26-42 and protocol/merkle.py).
void merkle_from_payloads(const uint8_t* payloads, size_t payload_len,
                          size_t count, uint8_t* nodes) {
#pragma omp parallel for schedule(static) if (count >= kParallelMin)
  for (long long i = 0; i < (long long)count; i++) {
    blake2b_512(payloads + (size_t)i * payload_len, payload_len,
                nodes + (count + (size_t)i) * 64);
  }
  for (size_t width = count / 2; width >= 1; width /= 2) {
#pragma omp parallel for schedule(static) if (width >= kParallelMin)
    for (long long i = 0; i < (long long)width; i++) {
      size_t k = width + (size_t)i;
      blake2b_512(nodes + 2 * k * 64, 128, nodes + k * 64);
    }
    if (width == 1) break;
  }
}
}
