"""Poseidon over the BN254 scalar field, the SNARK-friendly hash suite
(counterpart of ``risc0_tpu/hash/poseidon254.py``).

Mirrors risc0/zkp/src/core/hash/poseidon_254/mod.rs: a t=3, alpha=8 Poseidon
permutation (4 full + 42 partial + 4 full rounds) used by the identity_p254
predicate to re-commit a succinct receipt with digests that a BN254 Groth16
circuit can absorb cheaply.  Constants are the public hadeshash
poseidon_params_n254_t3_alpha8_M128 set (the repository's
poseidon254_consts.json, extracted from the reference's consts.rs:32-196,
read through ``assets.P254_CONSTS``).

The transcript permutation is host big-int arithmetic.  The bulk Merkle
hashing of a p254 prove (leaf rows and pair folds) runs in the host C++ of
csrc/poseidon254.cpp, threaded over the host's cores: BN254 arithmetic has
no kernel on the card.

Digests are (8,) uint32 word arrays like the other suites; a digest maps to
one Fr element by reading its 32 bytes little-endian (digest_to_fr,
mod.rs:98-107).
"""

from __future__ import annotations

import ctypes as Ct
import json
from functools import lru_cache

import numpy as np

from .. import field as F
from ..assets import P254_CONSTS

# BN254 (alt_bn128) scalar field modulus.
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

CELLS = 3
ROUNDS_HALF_FULL = 4
ROUNDS_PARTIAL = 42
ROUNDS_TOT = 2 * ROUNDS_HALF_FULL + ROUNDS_PARTIAL


@lru_cache(maxsize=1)
def _consts():
    with open(P254_CONSTS) as f:
        d = json.load(f)
    rc = [int(x) % FR_MOD for x in d["round_constants"]]
    mds = [int(x) % FR_MOD for x in d["mds"]]
    assert len(rc) == ROUNDS_TOT * CELLS and len(mds) == CELLS * CELLS
    return rc, mds


def _sbox(x: int) -> int:
    # x^8 (alpha=8; mod.rs:39-43)
    x2 = x * x % FR_MOD
    x4 = x2 * x2 % FR_MOD
    return x4 * x4 % FR_MOD


def permute(cells: list[int]) -> list[int]:
    """poseidon_mix (mod.rs:78-92): full/partial/full round schedule."""
    rc, mds = _consts()
    cells = list(cells)
    round_ = 0
    for r in range(ROUNDS_TOT):
        full = r < ROUNDS_HALF_FULL or r >= ROUNDS_HALF_FULL + ROUNDS_PARTIAL
        base = round_ * CELLS
        cells = [(c + rc[base + i]) % FR_MOD for i, c in enumerate(cells)]
        if full:
            cells = [_sbox(c) for c in cells]
        else:
            cells[0] = _sbox(cells[0])
        cells = [
            sum(mds[i * CELLS + j] * cells[j] for j in range(CELLS)) % FR_MOD
            for i in range(CELLS)
        ]
        round_ += 1
    return cells


def digest_to_fr(digest) -> int:
    """(8,) uint32 digest -> Fr via little-endian 32-byte repr."""
    b = np.asarray(digest, np.uint32).astype("<u4").tobytes()
    v = int.from_bytes(b, "little")
    if v >= FR_MOD:
        raise ValueError("digest is not a canonical Fr representation")
    return v


def fr_to_digest(v: int) -> np.ndarray:
    b = (v % FR_MOD).to_bytes(32, "little")
    return np.frombuffer(b, dtype="<u4").astype(np.uint32)


def hash_pair(a, b) -> np.ndarray:
    """mod.rs:141-147: cells=[0, fr(a), fr(b)] -> mix -> fr(cells[0])."""
    cells = [0, digest_to_fr(a), digest_to_fr(b)]
    return fr_to_digest(permute(cells)[0])


def unpadded_hash(elems) -> np.ndarray:
    """Sponge over BabyBear elems packed 8-per-Fr (mod.rs:109-138).

    `elems` is a 1-D uint32 array in Montgomery form (our HAL convention);
    the reference packs the *standard-form* u32 values with radix P.
    """
    vals = F.decode_np(np.asarray(elems, np.uint32).ravel())
    cells = [0, 0, 0]
    mul = 1
    idx = 1
    count = 0
    p = F.P
    for val in vals:
        cells[idx] = (cells[idx] + mul * int(val)) % FR_MOD
        mul = mul * p % FR_MOD
        count += 1
        if count == 8:
            mul = 1
            count = 0
            idx += 1
        if idx == 3:
            cells = permute(cells)
            cells[1] = 0
            cells[2] = 0
            idx = 1
    if idx != 1 or count != 0:
        cells = permute(cells)
    return fr_to_digest(cells[0])


# ---------------------------------------------------------------------------
# Native bulk path (csrc/poseidon254.cpp): Merkle row/pair hashing for the
# identity_p254 commit groups.  Field constants are pushed from here so the
# C++ carries no protocol data.
# ---------------------------------------------------------------------------

_R256 = 1 << 256


def _limbs(v: int) -> np.ndarray:
    return np.array([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)],
                    np.uint64)


def _mont(v: int) -> np.ndarray:
    return _limbs(v * _R256 % FR_MOD)


@lru_cache(maxsize=1)
def _native():
    from ..zkvm.native import lib as native_lib

    lib = native_lib()
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.p254_init.argtypes = [u64p, Ct.c_uint64, u64p, u64p, u64p, u64p, u64p]
    lib.p254_hash_rows.argtypes = [u32p, Ct.c_uint64, Ct.c_uint64, u32p,
                                   Ct.c_int]
    lib.p254_hash_pairs.argtypes = [u32p, u32p, Ct.c_uint64, u32p, Ct.c_int]

    rc, mds = _consts()
    nprime = (-pow(FR_MOD, -1, 1 << 64)) % (1 << 64)
    r2 = _limbs(_R256 * _R256 % FR_MOD)
    lib.p254_init(
        _limbs(FR_MOD), nprime, r2, _mont(1), _mont(F.P),
        np.concatenate([_mont(c) for c in rc]),
        np.concatenate([_mont(c) for c in mds]))
    return lib


def hash_rows(matrix, n_threads: int = 0) -> np.ndarray:
    """Per-row unpadded hash of a (cols, rows) Montgomery-form matrix;
    returns (rows, 8) digests.  Bulk path for Merkle leaf hashing."""
    m = F.decode_np(np.ascontiguousarray(np.asarray(matrix, np.uint32)))
    cols, rows = m.shape
    out = np.empty((rows, 8), np.uint32)
    _native().p254_hash_rows(m, cols, rows, out, n_threads)
    return out


def hash_pairs(left, right, n_threads: int = 0) -> np.ndarray:
    """Pairwise hash_pair of (n, 8) digest arrays; returns (n, 8)."""
    l = np.ascontiguousarray(np.asarray(left, np.uint32))
    r = np.ascontiguousarray(np.asarray(right, np.uint32))
    n = l.shape[0]
    out = np.empty((n, 8), np.uint32)
    _native().p254_hash_pairs(l, r, n, out, n_threads)
    return out


class Poseidon254Rng:
    """Fiat-Shamir transcript RNG (mod.rs:161-215)."""

    def __init__(self):
        self.cells = [0, 0, 0]

    def mix(self, digest):
        self.cells[1] = (self.cells[1] + digest_to_fr(digest)) % FR_MOD
        self.cells = permute(self.cells)

    def _draw_bits(self, nbits: int) -> int:
        """Low `nbits` bits of cells[2]'s canonical integer, then mix.

        The reference's is_odd/div2 loop (mod.rs:180-209) is exactly
        binary digit extraction of the canonical representative.
        """
        source = self.cells[2]
        self.cells = permute(self.cells)
        return source & ((1 << nbits) - 1)

    def random_bits(self, bits: int) -> int:
        return self._draw_bits(bits)

    def random_elem(self) -> int:
        """(low 160 bits of source) mod P, Montgomery form."""
        return F.s_encode(self._draw_bits(160) % F.P)

    def random_ext_elem(self) -> np.ndarray:
        return np.array([self.random_elem() for _ in range(4)], np.uint32)
