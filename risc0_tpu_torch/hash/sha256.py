"""SHA-256 hash suite primitives (host side; counterpart of
``risc0_tpu/hash/sha256.py``).

Mirrors the reference's SHA usage (risc0/zkp/src/core/hash/sha/{mod,cpu}.rs):

* Digest words are stored byte-swapped relative to the standard big-endian
  SHA-256 state words, so that the words' little-endian serialization equals
  the canonical digest byte stream (cpu.rs:58-63 `word.to_be()`).
* ``hash_pair(a, b)`` is a single SHA-256 compression of the 64-byte block
  a‖b starting from SHA256_INIT — no Merkle-Damgård padding (mod.rs:96-98).
* ``hash_raw_data_slice`` compresses the little-endian bytes of Montgomery-form
  words, zero-padded to a 64-byte boundary, again with no length trailer
  (cpu.rs:56-78).

SHA-256 itself is the FIPS 180-4 compression function implemented in plain
Python for the transcript and small hashes; the suite's Merkle trees hash
on the host through the batched numpy compression below.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

SHA256_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(state, block: bytes):
    """One SHA-256 compression round; state is 8 standard (big-endian) words."""
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip(state, [a, b, c, d, e, f, g, h])]


def _state_to_digest_words(state) -> np.ndarray:
    """Big-endian state words -> risc0 Digest word convention (byteswapped)."""
    return np.array(
        [int.from_bytes(x.to_bytes(4, "big"), "little") for x in state], np.uint32
    )


def _digest_words_to_state(words) -> list:
    return [int.from_bytes(int(x).to_bytes(4, "little"), "big") for x in words]


def hash_bytes(data: bytes) -> np.ndarray:
    """Standard SHA-256, result in Digest word convention."""
    d = hashlib.sha256(data).digest()
    return np.frombuffer(d, np.uint32).copy()


def hash_pair(a, b) -> np.ndarray:
    block = np.concatenate([np.asarray(a, np.uint32), np.asarray(b, np.uint32)])
    state = compress(SHA256_INIT, block.tobytes())
    return _state_to_digest_words(state)


def hash_raw_words(words) -> np.ndarray:
    """Unpadded (zero-filled) SHA-256 over little-endian u32 words."""
    data = np.asarray(words, np.uint32).tobytes()
    state = list(SHA256_INIT)
    for off in range(0, len(data) - len(data) % 64, 64):
        state = compress(state, data[off : off + 64])
    rem = len(data) % 64
    if rem:
        state = compress(state, data[-rem:] + b"\x00" * (64 - rem))
    return _state_to_digest_words(state)


# ---------------------------------------------------------------------------
# Vectorized batch compression (numpy) — drives sha-suite Merkle hashing
# ---------------------------------------------------------------------------

_KV = np.array(_K, np.uint32)


def _rotr_v(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def compress_batch(states: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Batched compression: states (n, 8) big-endian words, blocks (n, 16)
    big-endian words; returns new states (n, 8)."""
    with np.errstate(over="ignore"):
        w = [blocks[:, i].astype(np.uint32) for i in range(16)]
        for i in range(16, 64):
            s0 = _rotr_v(w[i - 15], 7) ^ _rotr_v(w[i - 15], 18) ^ (w[i - 15] >> np.uint32(3))
            s1 = _rotr_v(w[i - 2], 17) ^ _rotr_v(w[i - 2], 19) ^ (w[i - 2] >> np.uint32(10))
            w.append(w[i - 16] + s0 + w[i - 7] + s1)
        a, b, c, d, e, f, g, h = (states[:, i].astype(np.uint32) for i in range(8))
        for i in range(64):
            s1 = _rotr_v(e, 6) ^ _rotr_v(e, 11) ^ _rotr_v(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + s1 + ch + _KV[i] + w[i]
            s0 = _rotr_v(a, 2) ^ _rotr_v(a, 13) ^ _rotr_v(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = s0 + maj
            h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
        new = np.stack([a, b, c, d, e, f, g, h], axis=1)
        return (states.astype(np.uint32) + new).astype(np.uint32)


def _bswap(x: np.ndarray) -> np.ndarray:
    return x.byteswap() if x.dtype.byteorder in ("=", "<") else x


def hash_rows_np(matrix: np.ndarray) -> np.ndarray:
    """sha-suite hash_rows: (cols, rows) Montgomery words -> (rows, 8) digests.

    Each column-tuple is compressed as its little-endian byte stream padded
    with zeros to 64-byte blocks, no length trailer (reference cpu.rs:56-78);
    digest words byteswapped per the Digest convention.
    """
    cols, rows = matrix.shape
    nblocks = (cols + 15) // 16
    padded = np.zeros((nblocks * 16, rows), np.uint32)
    padded[:cols] = matrix
    states = np.tile(np.array(SHA256_INIT, np.uint32), (rows, 1))
    for blk in range(nblocks):
        # native LE bytes interpreted as big-endian words for compression
        block = _bswap(padded[blk * 16 : (blk + 1) * 16].T.copy())
        states = compress_batch(states, block)
    return _bswap(states)


def hash_pairs_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """sha-suite batched hash_pair: (n, 8), (n, 8) -> (n, 8)."""
    n = left.shape[0]
    block = _bswap(np.concatenate([left, right], axis=1).astype(np.uint32))
    states = np.tile(np.array(SHA256_INIT, np.uint32), (n, 1))
    return _bswap(compress_batch(states, block))
