"""The keccak coprocessor's claims, computed plainly (FIPS 202 and risc0
circuit/keccak/src/lib.rs:49-92), and the claims that compose them into a
receipt (risc0 zkvm/src/claim/receipt.rs UnionClaim and Assumption,
zkvm/src/mmr.rs).

- keccak-f[1600]: 24 rounds of theta, rho, pi, chi and iota over 25 lanes
  of 64 bits, lane (x, y) at index x + 5y.
- A batch's claim: SHA-256 compressions, from the standard initial state
  and with no padding, over each permuted state before and after keccak-f,
  each as its 25 lanes little-endian and 56 zero bytes (four blocks); the
  claim is the final state's eight words, little-endian.
- The root claim of a guest's batches: each batch claim is an
  Assumption{claim, the allowed-set root}; two merge into the UnionClaim of
  their Assumption digests, the lesser (as eight words) on the left; the
  batches merge in mountain-range order, equal heights first, then the
  peaks left to right.
"""

import hashlib
import struct

from .claims import ZERO, tagged_struct

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y] (FIPS 202 table 2)
ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
       [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


def _rotl(v, n):
    return ((v << n) | (v >> (64 - n))) & M64 if n else v


def keccak_f(state):
    """keccak-f[1600] of 25 lanes (lane x + 5y); returns a new list."""
    a = [int(v) for v in state]
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y] ^ d[x],
                                                         ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & M64
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


SHA_K = [
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
SHA_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
          0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def _rotr(v, n):
    return ((v >> n) | (v << (32 - n))) & M32


def sha256_compress(h, block: bytes):
    """One SHA-256 compression (FIPS 180-4 6.2.2) of a 64-byte block into
    the eight-word state `h`; returns the new state."""
    w = list(struct.unpack(">16I", block))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        t1 = (hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g)) + SHA_K[t] + w[t]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & M32
        a, b, c, d, e, f, g, hh = (t1 + t2) & M32, a, b, c, (d + t1) & M32, \
            e, f, g
    return tuple((x + y) & M32 for x, y in zip(h, (a, b, c, d, e, f, g, hh)))


def state_bytes(state) -> bytes:
    """25 lanes, little-endian: the 200 bytes of a keccak state."""
    return struct.pack("<25Q", *state)


def chain(start, sizes):
    """The states each batch permutes when one state is permuted in place
    `sizes[i]` times for batch i, and the final state: (batches, final)."""
    state = [int(v) for v in start]
    batches = []
    for n in sizes:
        batch = []
        for _ in range(n):
            batch.append(state)
            state = keccak_f(state)
        batches.append(batch)
    return batches, state


def batch_claim(states) -> bytes:
    """The claim digest that the keccak circuit commits for a batch."""
    h = SHA_IV
    for state in states:
        for s in (state, keccak_f(state)):
            data = state_bytes(s) + bytes(56)
            for i in range(0, 256, 64):
                h = sha256_compress(h, data[i:i + 64])
    return struct.pack("<8I", *h)


def assumption(claim: bytes, control_root: bytes) -> bytes:
    return tagged_struct("risc0.Assumption", [claim, control_root], [])


def union_claim(a: bytes, b: bytes) -> bytes:
    """The UnionClaim digest of two Assumption digests."""
    if struct.unpack("<8I", b) < struct.unpack("<8I", a):
        a, b = b, a
    return tagged_struct("risc0.UnionClaim", [a, b], [])


def root_claim(claims, control_root: bytes) -> bytes:
    """The claim of the union tree's root over the batch claims, merged in
    mountain-range order under the allowed-set root."""
    def merge(a, b):
        return union_claim(assumption(a, control_root),
                           assumption(b, control_root))

    peaks = []  # (height, claim), the smallest last
    for c in claims:
        height = 0
        while peaks and peaks[-1][0] == height:
            c = merge(c, peaks.pop()[1])
            height += 1
        peaks.append((height, c))
    acc = peaks[0][1]
    for _h, c in peaks[1:]:
        acc = merge(acc, c)
    return acc


def assumptions_digest(digests) -> bytes:
    """risc0.Assumptions of a list of Assumption digests, head first."""
    acc = ZERO
    for d in reversed(digests):
        acc = tagged_struct("risc0.Assumptions", [d, acc], [])
    return acc


def output_with(journal: bytes, assumption_digests) -> bytes:
    """risc0.Output of a journal and a list of assumptions."""
    return tagged_struct("risc0.Output",
                         [hashlib.sha256(journal).digest(),
                          assumptions_digest(assumption_digests)], [])
