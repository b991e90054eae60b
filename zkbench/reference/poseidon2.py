"""Poseidon2 over BabyBear, width 24, on canonical values: the permutation,
the unpadded sponge (rate 16, absorb by setting) and the two-to-one hash.

Round structure (risc0 zkp/src/core/hash/poseidon2): the external layer
first, 4 full rounds, 21 partial rounds, 4 full rounds; S-box x^7; the
external layer applies M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] to
each block of four cells and adds to each cell the sum of its column over
the blocks; the internal layer is all-ones plus a diagonal.  The constants
are the published ones, in poseidon2_constants.json beside this file.
"""

import json
import os

from .field import P

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "poseidon2_constants.json")) as _f:
    _C = json.load(_f)

CELLS = _C["cells"]
RATE = _C["rate"]
OUT = _C["out"]
HALF_FULL = _C["rounds_half_full"]
PARTIAL = _C["rounds_partial"]
_RC = [_C["round_constants"][r * CELLS:(r + 1) * CELLS]
       for r in range(2 * HALF_FULL + PARTIAL)]
_DIAG = _C["m_int_diag"]
_M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))


def _sbox(x: int) -> int:
    return pow(x, 7, P)


def _external(c):
    out = []
    for blk in range(0, CELLS, 4):
        v = c[blk:blk + 4]
        out += [sum(m * x for m, x in zip(row, v)) for row in _M4]
    sums = [sum(out[j::4]) for j in range(4)]
    return [(x + sums[i % 4]) % P for i, x in enumerate(out)]


def permute(cells):
    c = _external(list(cells))
    for rnd, rc in enumerate(_RC):
        if HALF_FULL <= rnd < HALF_FULL + PARTIAL:
            c[0] = _sbox((c[0] + rc[0]) % P)
            total = sum(c)
            c = [(total + x * d) % P for x, d in zip(c, _DIAG)]
        else:
            c = _external([_sbox((x + k) % P) for x, k in zip(c, rc)])
    return c


def hash_elems(elems) -> tuple:
    """The unpadded sponge of a sequence of values: an 8-value digest."""
    elems = list(elems)
    state = [0] * CELLS
    full, rem = divmod(len(elems), RATE)
    for i in range(full):
        state[:RATE] = elems[i * RATE:(i + 1) * RATE]
        state = permute(state)
    if rem or not elems:
        state[:RATE] = elems[full * RATE:] + [0] * (RATE - rem)
        state = permute(state)
    return tuple(state[:OUT])


def hash_pair(a, b) -> tuple:
    return hash_elems(list(a) + list(b))


class Transcript:
    """The Fiat-Shamir sponge of the seal (risc0 poseidon2/rng.rs)."""

    def __init__(self):
        self.cells = [0] * CELLS
        self.used = 0

    def mix(self, digest):
        if self.used:
            self.cells = permute(self.cells)
            self.used = 0
        for i, d in enumerate(digest):
            self.cells[i] = (self.cells[i] + d) % P
        self.cells = permute(self.cells)

    def elem(self) -> int:
        if self.used == RATE:
            self.cells = permute(self.cells)
            self.used = 0
        out = self.cells[self.used]
        self.used += 1
        return out

    def ext_elem(self) -> tuple:
        return tuple(self.elem() for _ in range(4))

    def bits(self, n: int) -> int:
        """The low `n` bits of the first nonzero of four draws."""
        val = self.elem()
        for _ in range(3):
            new = self.elem()
            if val == 0:
                val = new
        return val & ((1 << n) - 1)
