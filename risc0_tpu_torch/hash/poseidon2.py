"""Poseidon2 permutation over BabyBear (t=24): numpy host version and plain
torch version (counterpart of ``risc0_tpu/hash/poseidon2.py``).

Initial external MDS layer, 4 full rounds, 21 partial rounds, 4 full
rounds; S-box x^7; external matrix = circ(2*M4, M4, ...) through the
appendix-B butterfly; internal matrix = all-ones + diag(M_INT_DIAG_HZN).
A digest is the first 8 cells of the state, as raw Montgomery words.

Bulk hashing (``hash_rows``, ``hash_pairs``) goes through the CUDA
kernels in ``risc0_tpu_torch/hal/cuda/poseidon2.py``; the torch
``permute`` below is their plain version.  The sponge and pair hash of
the Fiat-Shamir transcript run on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from risc0_tpu.hash.poseidon2_consts import (
    CELLS,
    CELLS_OUT,
    CELLS_RATE,
    M_INT_DIAG_HZN,
    ROUND_CONSTANTS,
    ROUNDS_HALF_FULL,
    ROUNDS_PARTIAL,
)

from .. import field as F

# Constants in Montgomery form (host numpy arrays).
RC_MONT = F.encode_np(np.array(ROUND_CONSTANTS, np.uint32)).reshape(-1, CELLS)
MINT_MONT = F.encode_np(np.array(M_INT_DIAG_HZN, np.uint32))
ROUNDS = 2 * ROUNDS_HALF_FULL + ROUNDS_PARTIAL


# ---------------------------------------------------------------------------
# host version: python ints in standard form, one state at a time
# ---------------------------------------------------------------------------
#
# The permutation commutes with Montgomery encoding (every step is a field
# add or product), so a state is decoded once, permuted with python-int
# arithmetic on standard-form words, and encoded back: the same words as
# the Montgomery numpy version, at a small fraction of its per-call cost
# (the transcript and the verifier permute one state at a time).

_RC_STD = [ROUND_CONSTANTS[r * CELLS : (r + 1) * CELLS] for r in range(ROUNDS)]
_P = F.P


def _sbox_py(x: int) -> int:
    x2 = x * x % _P
    return x2 * x2 % _P * x2 % _P * x % _P


def _m_ext_py(c: list) -> list:
    out = []
    for blk in range(0, CELLS, 4):
        c0, c1, c2, c3 = c[blk : blk + 4]
        t0 = c0 + c1
        t1 = c2 + c3
        t2 = 2 * c1 + t1
        t3 = 2 * c3 + t0
        t4 = 4 * t1 + t3
        t5 = 4 * t0 + t2
        out += [t3 + t5, t5, t2 + t4, t4]
    sums = [sum(out[j::4]) for j in range(4)]
    return [(v + sums[i % 4]) % _P for i, v in enumerate(out)]


def _permute_std(c: list) -> list:
    c = _m_ext_py(c)
    for rnd in range(ROUNDS):
        rc = _RC_STD[rnd]
        if ROUNDS_HALF_FULL <= rnd < ROUNDS_HALF_FULL + ROUNDS_PARTIAL:
            c[0] = _sbox_py((c[0] + rc[0]) % _P)
            total = sum(c)
            c = [(total + v * d) % _P for v, d in zip(c, M_INT_DIAG_HZN)]
        else:
            c = _m_ext_py([_sbox_py((v + k) % _P) for v, k in zip(c, rc)])
    return c


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation of (..., 24) uint32 Montgomery words."""
    state = np.asarray(state, np.uint32)
    out = np.empty_like(state)
    flat_in = state.reshape(-1, CELLS)
    flat_out = out.reshape(-1, CELLS)
    for i, row in enumerate(flat_in.tolist()):
        std = _permute_std([w * F.R_INV % _P for w in row])
        flat_out[i] = [v * F.R % _P for v in std]
    return out


def unpadded_hash_np(elems: np.ndarray) -> np.ndarray:
    """Host unpadded sponge hash of a 1-D Montgomery-form array.

    Rate-16 absorb with *set* (not add), zero-padding the final partial
    block, one permutation even for an empty input (mod.rs:221-245);
    returns an 8-word digest.
    """
    elems = np.asarray(elems, np.uint32).ravel()
    n = len(elems)
    state = np.zeros(CELLS, np.uint32)
    full, rem = divmod(n, CELLS_RATE)
    for i in range(full):
        state[:CELLS_RATE] = elems[i * CELLS_RATE : (i + 1) * CELLS_RATE]
        state = permute_np(state)
    if rem != 0 or n == 0:
        state[:rem] = elems[full * CELLS_RATE :]
        state[rem:CELLS_RATE] = 0
        state = permute_np(state)
    return state[:CELLS_OUT].copy()


def hash_pair_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hash two 8-word digests (Montgomery words; reference mod.rs:47-60)."""
    return unpadded_hash_np(
        np.concatenate([np.asarray(a, np.uint32), np.asarray(b, np.uint32)]))


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------

def _sbox_t(x):
    x2 = F.mul(x, x)
    x4 = F.mul(x2, x2)
    return F.mul(F.mul(x4, x2), x)


def _m_ext_t(state):
    """External layer: the 4x4 circulant butterfly on each of the 6 blocks
    (mod.rs:137-176), then each cell adds its column's sum over blocks."""
    b = state.reshape(state.shape[:-1] + (CELLS // 4, 4))
    c0, c1, c2, c3 = b.unbind(-1)
    t0 = F.add(c0, c1)
    t1 = F.add(c2, c3)
    t2 = F.add(F.add(c1, c1), t1)
    t3 = F.add(F.add(c3, c3), t0)
    t4 = F.add(F.add(F.add(t1, t1), F.add(t1, t1)), t3)
    t5 = F.add(F.add(F.add(t0, t0), F.add(t0, t0)), t2)
    out = torch.stack([F.add(t3, t5), t5, F.add(t2, t4), t4], dim=-1)
    out = F.add(out, F.sum_mod(out, -2).unsqueeze(-2))
    return out.reshape(state.shape)


_DEVICE_CONSTS: dict = {}


def _consts(device):
    key = str(device)
    c = _DEVICE_CONSTS.get(key)
    if c is None:
        c = (torch.from_numpy(RC_MONT.view(np.int32)).to(device),
             torch.from_numpy(MINT_MONT.view(np.int32)).to(device))
        _DEVICE_CONSTS[key] = c
    return c


def permute(state):
    """Poseidon2 permutation on (..., 24) int32 Montgomery tensors."""
    rc, mint = _consts(state.device)
    state = _m_ext_t(state)
    for rnd in range(ROUNDS):
        if ROUNDS_HALF_FULL <= rnd < ROUNDS_HALF_FULL + ROUNDS_PARTIAL:
            c0 = _sbox_t(F.add(state[..., 0], rc[rnd, 0]))
            state = torch.cat([c0[..., None], state[..., 1:]], dim=-1)
            total = F.sum_mod(state, -1)
            state = F.add(total[..., None], F.mul(state, mint))
        else:
            state = _m_ext_t(_sbox_t(F.add(state, rc[rnd])))
    return state


def hash_rows(matrix):
    """(cols, rows) Montgomery words -> (rows, 8) sponge digests."""
    from ..hal.cuda import poseidon2 as k

    return k.hash_rows(matrix)


def hash_pairs(left, right):
    """(n, 8), (n, 8) digests -> (n, 8) 2-to-1 compressions."""
    from ..hal.cuda import poseidon2 as k

    return k.hash_pairs(left, right)
