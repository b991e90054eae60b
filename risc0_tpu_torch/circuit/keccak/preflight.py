# The port's own copy of risc0_tpu/circuit/keccak/preflight.py.
"""Keccak circuit preflight: cycle schedule, scatter data, preimage table.

Literal port of the reference preflight (risc0/circuit/keccak/src/prove/
preflight.rs): each preimage contributes Read -> 4x9 ShaIn -> 2 Expand ->
24x5 Keccak -> Write -> 4x9 ShaOut cycles, with an Init cycle first and
Shutdown padding to 2^po2.  All nondeterminism is carried by the scatter
list (control state, cycle mux onehot, bit/short-packed state) and the
preimage table consumed by the getPreimage extern.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

from ...assets import KECCAK_DATA


@lru_cache(maxsize=None)
def _scatter_cols():
    """Scatter column offsets of the keccak witgen (the ``scatter`` entry
    of its extracted ``witgen_meta.json``)."""
    with open(os.path.join(KECCAK_DATA, "witgen_meta.json")) as f:
        return json.load(f)["scatter"]


SHA_INIT = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

SHA_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

KECCAK_IOTA = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808a,
    0x8000000080008000, 0x000000000000808b, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008a,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000a,
    0x000000008000808b, 0x800000000000008b, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800a, 0x800000008000000a, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
KECCAK_RHO = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8,
              25, 43, 62, 18, 39, 61, 20, 44]
KECCAK_PI = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13,
             12, 2, 20, 14, 22, 9, 6, 1]

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1


def _rotl64(x, n):
    return ((x << n) | (x >> (64 - n))) & M64


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def theta_p1(s):
    return [s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20]
            for i in range(5)]


def theta_p2_rho_pi(s, bc):
    for i in range(5):
        t = bc[(i + 4) % 5] ^ _rotl64(bc[(i + 1) % 5], 1)
        for j in range(0, 25, 5):
            s[j + i] ^= t
    t1 = s[1]
    for pi, rho in zip(KECCAK_PI, KECCAK_RHO):
        t2 = s[pi]
        s[pi] = _rotl64(t1, rho)
        t1 = t2


def chi_iota(s, rnd):
    for j in range(0, 25, 5):
        t = s[j:j + 5]
        for i in range(5):
            s[j + i] ^= (~t[(i + 1) % 5] & M64) & t[(i + 2) % 5]
    s[0] ^= KECCAK_IOTA[rnd]


def keccak_f(state):
    """Full keccak-f[1600] permutation (for tests / digest checks)."""
    s = list(state)
    for rnd in range(24):
        bc = theta_p1(s)
        theta_p2_rho_pi(s, bc)
        chi_iota(s, rnd)
    return s


def compute_sha_infos(state, data):
    """SHA-256 compress recording (a, e, w) every 8 rounds
    (reference preflight.rs:174-258); mutates `state`."""
    a, b, c, d, e, f, g, h = state
    w = [0] * 64
    ret = []
    cur = {"a": [0] * 8, "e": [0] * 8, "w": [0] * 8}
    for i in range(64):
        if i < 16:
            x = data[i] & M32
            w[i] = ((x & 0xFF) << 24 | (x & 0xFF00) << 8 |
                    (x >> 8) & 0xFF00 | (x >> 24) & 0xFF)
        else:
            s1 = _rotr32(w[i - 2], 17) ^ _rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10)
            s0 = _rotr32(w[i - 15], 7) ^ _rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3)
            w[i] = (s1 + w[i - 7] + s0 + w[i - 16]) & M32
        e1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ (~e & M32 & g)
        t1 = (h + e1 + ch + SHA_K[i] + w[i]) & M32
        e0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (e0 + maj) & M32
        h, g, f = g, f, e
        e = (d + t1) & M32
        d, c, b = c, b, a
        a = (t1 + t2) & M32
        cur["a"][i % 8] = a
        cur["e"][i % 8] = e
        cur["w"][i % 8] = w[i]
        if i % 8 == 7:
            ret.append({k: list(v) for k, v in cur.items()})
    state[0] = (state[0] + a) & M32
    state[1] = (state[1] + b) & M32
    state[2] = (state[2] + c) & M32
    state[3] = (state[3] + d) & M32
    state[4] = (state[4] + e) & M32
    state[5] = (state[5] + f) & M32
    state[6] = (state[6] + g) & M32
    state[7] = (state[7] + h) & M32
    ret.append(_sha_state_info(state))
    return ret


def _sha_state_info(state):
    info = {"a": [0] * 8, "e": [0] * 8, "w": [0] * 8}
    for i in range(4):
        info["a"][7 - i] = state[i]
        info["e"][7 - i] = state[4 + i]
    return info


# Control encoding (reference preflight.rs:56-113)
def _ctrl(cycle_type, sub_type=0, block=0, rnd=0):
    return cycle_type | (sub_type << 8) | (block << 16) | (rnd << 24), \
        cycle_type


class KeccakPreflight:
    def __init__(self, inputs, cycles):
        """inputs: list of 25-element u64 state lists; cycles: 2^po2."""
        self.data = [0] * 100
        self.scatter = []   # (offset, row, col, count, bits)
        self.cur_preimage = []
        self.cycle = 0
        self.preimages = [list(s) for s in inputs]

        cur_sha = list(SHA_INIT)
        sflat = self._write_words(cur_sha)
        cur_idx = 0
        self._add_cycle(_ctrl(11), 0, 0, sflat, cur_idx)  # Init

        for kstate in inputs:
            kstate = list(kstate)
            # Read
            kflat, local = self._write_kflat(kstate)
            bits = self._write_sha_info(_sha_state_info(cur_sha))
            self._add_cycle(_ctrl(1), bits, kflat, sflat, cur_idx)
            cur_idx += 1
            sflat = self._write_sha(cur_sha, local, kflat, sflat, cur_idx,
                                    True)
            # Expand
            bits = self._write_keccak(kstate, False)
            self._add_cycle(_ctrl(2, 0), bits, kflat, sflat, cur_idx)
            bits = self._write_keccak(kstate, True)
            self._add_cycle(_ctrl(2, 1), bits, kflat, sflat, cur_idx)
            # Keccak rounds
            for rnd in range(24):
                theta = theta_p1(kstate)
                bits = self._write_theta(theta)
                self._add_cycle(_ctrl(4, 0, 0, rnd), bits, kflat, sflat,
                                cur_idx)
                theta_p2_rho_pi(kstate, theta)
                bits = self._write_keccak(kstate, False)
                self._add_cycle(_ctrl(5, 0, 0, rnd), bits, kflat, sflat,
                                cur_idx)
                bits = self._write_keccak(kstate, True)
                self._add_cycle(_ctrl(6, 0, 0, rnd), bits, kflat, sflat,
                                cur_idx)
                chi_iota(kstate, rnd)
                bits = self._write_keccak(kstate, False)
                self._add_cycle(_ctrl(7, 0, 0, rnd), bits, kflat, sflat,
                                cur_idx)
                bits = self._write_keccak(kstate, True)
                self._add_cycle(_ctrl(8, 0, 0, rnd), bits, kflat, sflat,
                                cur_idx)
            # Write
            kflat, local = self._write_kflat(kstate)
            bits = self._write_sha_info(_sha_state_info(cur_sha))
            self._add_cycle(_ctrl(3), bits, kflat, sflat, cur_idx)
            sflat = self._write_sha(cur_sha, local, kflat, sflat, cur_idx,
                                    False)

        if self.cycle > cycles:
            raise ValueError(f"po2 too small: {self.cycle} > {cycles}")
        while self.cycle < cycles:
            self._add_cycle(_ctrl(0), 0, 0, sflat, cur_idx)  # Shutdown

        self.final_sha = cur_sha

    # -- helpers ------------------------------------------------------------
    def _write_words(self, words):
        off = len(self.data)
        self.data.extend(w & M32 for w in words)
        return off

    def _write_sha_info(self, info):
        off = len(self.data)
        self.data.extend(info["a"])
        self.data.extend(info["e"])
        self.data.extend(info["w"])
        self.data.append(0)
        return off

    def _write_sha(self, cur_sha, local, kflat, sflat, cur_idx, is_in):
        for block in range(4):
            infos = compute_sha_infos(cur_sha, local[16 * block:])
            for i in range(8):
                bits = self._write_sha_info(infos[i])
                ctrl = _ctrl(9, 0 if is_in else 1, block, i)
                self._add_cycle(ctrl, bits, kflat, sflat, cur_idx)
            sflat = self._write_words(cur_sha)
            bits = self._write_sha_info(infos[8])
            ctrl = _ctrl(10, 0 if is_in else 1, block, 0)
            self._add_cycle(ctrl, bits, kflat, sflat, cur_idx)
        return sflat

    def _write_kflat(self, kstate):
        local = []
        for x in kstate:
            local.append(x & M32)
            local.append((x >> 32) & M32)
        off = len(self.data)
        self.data.extend(local)
        local = local + [0] * 14  # 4 SHA blocks of 16 words
        return off, local

    def _write_keccak(self, kstate, high):
        off = len(self.data)
        for x in kstate:
            self.data.append((x >> 32) & M32 if high else x & M32)
        return off

    def _write_theta(self, theta):
        off = len(self.data)
        for x in theta:
            self.data.append(x & M32)
            self.data.append((x >> 32) & M32)
        self.data.extend([0] * 20)
        return off

    def _add_cycle(self, ctrl, bits, kflat, sflat, preimage_idx):
        cols = _scatter_cols()
        ctrl_word, cycle_type = ctrl
        row = self.cycle
        off = len(self.data)
        self.data.append(ctrl_word)
        self.scatter.append((off, row, cols["control_state"], 4, 8))
        self.data.append(1 << cycle_type)
        self.scatter.append((off + 1, row, cols["cycle_mux"], 12, 1))
        self.scatter.append((bits, row, cols["bits"], 800, 1))
        self.scatter.append((kflat, row, cols["kflat"], 100, 16))
        self.scatter.append((sflat, row, cols["sflat"], 16, 16))
        self.cur_preimage.append(preimage_idx)
        self.cycle += 1


def apply_scatter(data_buf, scatter, words):
    """Unpack scatter entries into the column-major data buffer
    (reference hal scatter: count fields of `bits` each, LSB-first)."""
    words = np.asarray(words, dtype=np.uint64)
    for off, row, col, count, bits in scatter:
        per_word = 32 // bits
        n_words = (count + per_word - 1) // per_word
        w = words[off:off + n_words]
        idx = np.arange(count)
        shift = ((idx % per_word) * bits).astype(np.uint64)
        vals = (w[idx // per_word] >> shift) & np.uint64((1 << bits) - 1)
        data_buf[col:col + count, row] = vals.astype(np.uint32)
