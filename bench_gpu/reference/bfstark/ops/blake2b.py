"""BLAKE2b-512 over batches of equal-length messages.

The commitment layer hashes millions of fixed-width leaf payloads
(little-endian u64 rows [+ salt]) with BLAKE2b-512. `blake2b_words` hashes a
whole batch in one call, `blake2b_words_plain`: the compression function as
a torch program vectorised over the message axis, on any device.

Message convention: (n, W) int64 words, W % 16 == 0 (whole 128-byte
blocks), holding the LE u64 words of each message zero-padded past
`msg_len` bytes. Digests come back as (n, 8) int64 words, whose LE bytes
equal `hashlib.blake2b(payload).digest()` (digest_size=64, no key).
"""

from __future__ import annotations

import torch

from ..convert import to_i64

_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

# h0 ^= 0x0101kknn : fanout=1, depth=1, keylen=0, digest_size=64
_H0 = _IV[0] ^ 0x01010040

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


# ---------------------------------------------------------------------------
# the compression function as torch ops
# ---------------------------------------------------------------------------


def _rotr(x, r: int):
    """64-bit rotate right on int64 bit patterns (logical shift = arithmetic
    shift + mask)."""
    return ((x >> r) & ((1 << (64 - r)) - 1)) | (x << (64 - r))


def _g(v, a, b, c, d, x, y):
    v[a] = v[a] + v[b] + x
    v[d] = _rotr(v[d] ^ v[a], 32)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 24)
    v[a] = v[a] + v[b] + y
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 63)


def _compress(h, m, t_bytes: int, last: bool, n: int, device):
    def bc(word):
        return torch.full((n,), to_i64(word), dtype=torch.int64, device=device)

    v = list(h) + [bc(w) for w in _IV]
    v[12] = v[12] ^ to_i64(t_bytes)
    if last:
        v[14] = v[14] ^ -1
    for r in range(12):
        s = _SIGMA[r % 10]
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2b_words_plain(words, msg_len: int):
    """BLAKE2b-512 of each row of `words` as a torch program over the
    message axis: 12 rounds × 8 G-functions unrolled, 64-bit state words
    as int64 tensors."""
    n, W = words.shape
    dev = words.device
    h = [
        torch.full((n,), to_i64(w), dtype=torch.int64, device=dev)
        for w in [_H0] + _IV[1:]
    ]
    nblocks = W // 16
    for i in range(nblocks):
        m = [words[:, 16 * i + j] for j in range(16)]
        last = i == nblocks - 1
        t = msg_len if last else (i + 1) * 128
        h = _compress(h, m, t, last, n, dev)
    return torch.stack(h, dim=1)


def blake2b_words(words, msg_len: int):
    """BLAKE2b-512 over a batch of equal-length messages.

    words: (n, W) int64, contiguous, W % 16 == 0, zero-padded past
    `msg_len` bytes, with 8·(W-16) < msg_len <= 8·W (the last block holds
    payload). Returns (n, 8) int64 digest words."""
    if words.dtype != torch.int64 or words.dim() != 2:
        raise ValueError("blake2b_words takes a 2-D int64 tensor")
    W = int(words.shape[1])
    if W % 16 or W == 0 or not 8 * (W - 16) < msg_len <= 8 * W:
        raise ValueError(f"bad message shape: W={W}, msg_len={msg_len}")
    return blake2b_words_plain(words, msg_len)


def merkle_parents(d):
    """One Merkle level: (2K, 8) child digests (heap order) -> (K, 8)
    parents blake2b(left_64B ‖ right_64B), one exactly-full block."""
    n = d.shape[0] // 2
    return blake2b_words(d.reshape(n, 16).contiguous(), 128)


def digests_to_bytes(d) -> bytes:
    """(N, 8) int64 digest words -> concatenated 64-byte digests."""
    from ..convert import tensor_to_u64

    return tensor_to_u64(d).astype("<u8").tobytes()
