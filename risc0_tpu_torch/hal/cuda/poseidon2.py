"""Poseidon2 row hashing, pair compression and Merkle folding: CUDA kernels
and their plain torch versions (counterpart of
``risc0_tpu/hal/pallas/poseidon2.py``).

``hash_rows``, ``hash_pairs`` and ``merkle_fold`` take the plain version
only for tensors on the CPU; for a CUDA tensor they launch the kernels in
``risc0_tpu_torch/csrc/poseidon2.cu`` or raise.  ``hash_rows.launches``
counts the row-hash launches; ``hash_pairs.launches`` counts the launches
of the pair kernel, which ``hash_pairs`` runs for one layer and
``merkle_fold`` for up to FOLD_LEVELS layers at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from ...hash.poseidon2 import (CELLS, CELLS_OUT, CELLS_RATE, MINT_MONT,
                               RC_MONT, ROUNDS, permute)
from ...hash.poseidon2_consts import ROUNDS_HALF_FULL, ROUNDS_PARTIAL
from . import build

# levels one launch of the pair kernel folds: a block of 256 threads
# hashes 512 digests down to one (FOLD_THREADS in poseidon2.cu)
FOLD_LEVELS = 9

_constants_set: set = set()


def folded_round_constants() -> np.ndarray:
    """(ROUNDS + 1, 24) u32: row r holds the constants the kernels add right
    after the linear layer that precedes round r (row 0: after the initial
    external layer; row ROUNDS: none).  A full round's row is its 24
    constants, a partial round's row only cell 0's: the reference adds
    nothing to the other cells there."""
    rcf = np.zeros((ROUNDS + 1, CELLS), np.uint32)
    partial = np.arange(ROUNDS_HALF_FULL, ROUNDS_HALF_FULL + ROUNDS_PARTIAL)
    full = np.setdiff1d(np.arange(ROUNDS), partial)
    rcf[full] = RC_MONT[full]
    rcf[partial, 0] = RC_MONT[partial, 0]
    return rcf


def fold_plan(n_bits: int) -> list:
    """Levels folded by each launch of the pair kernel for a tree of
    2^n_bits leaves, bottom first.  The top levels are few digests and
    latency-bound: up to FOLD_LEVELS a launch, the lowest such launch
    taking the remainder.  Below the top 2 * FOLD_LEVELS levels the layers
    are wide, and a launch that folds many of them idles its blocks on
    their narrow upper levels: two levels a launch."""
    plan = []
    while n_bits - 2 * len(plan) > 2 * FOLD_LEVELS:
        plan.append(2)
    rest = n_bits - 2 * len(plan)
    if rest:
        top = -(-rest // FOLD_LEVELS)
        plan += [rest - FOLD_LEVELS * (top - 1)] + [FOLD_LEVELS] * (top - 1)
    return plan


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(t, what: str, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, got {tuple(t.shape)}")


def _lib_for(device):
    lib = build.library()
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _constants_set:
        rc = np.ascontiguousarray(folded_round_constants().ravel())
        mint = np.ascontiguousarray(MINT_MONT)
        with torch.cuda.device(idx):
            build.check(lib.p2_set_constants(rc.ctypes.data,
                                             mint.ctypes.data),
                        "p2_set_constants")
        _constants_set.add(idx)
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def hash_rows_plain(matrix):
    """(cols, rows) -> (rows, 8): rate-16 absorb with set semantics,
    zero-padded last chunk, one permutation even when cols == 0."""
    cols, rows = matrix.shape
    state = torch.zeros((rows, CELLS), dtype=torch.int32, device=matrix.device)
    for c0 in range(0, max(cols, 1), CELLS_RATE):
        chunk = matrix[c0 : c0 + CELLS_RATE]
        state[:, :CELLS_RATE] = 0
        state[:, : chunk.shape[0]] = chunk.T
        state = permute(state)
    return state[:, :CELLS_OUT].contiguous()


def hash_pairs_plain(left, right):
    """(n, 8), (n, 8) -> (n, 8): permute(left | right | 0), first 8 cells."""
    zeros = torch.zeros_like(left)
    return permute(torch.cat([left, right, zeros], dim=1))[:, :CELLS_OUT] \
        .contiguous()


def _tree_bits(leaves, what: str) -> int:
    n = leaves.shape[0]
    if leaves.dim() != 2 or leaves.shape[1] != CELLS_OUT or n & (n - 1) or \
            n == 0:
        raise ValueError(f"{what}: expected (2^k, 8) leaf digests, got "
                         f"{tuple(leaves.shape)}")
    return n.bit_length() - 1


def merkle_fold_plain(leaves):
    """Every Merkle layer above (2^k, 8) leaf digests: [(2^(k-1), 8), ...,
    (1, 8)], each layer hash_pairs_plain of the one below's even and odd
    rows."""
    _tree_bits(leaves, "merkle_fold")
    layers, cur = [], leaves
    while cur.shape[0] > 1:
        cur = hash_pairs_plain(cur[0::2], cur[1::2])
        layers.append(cur)
    return layers


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def hash_rows(matrix):
    """Poseidon2 digest of every column of a (cols, rows) int32 matrix of
    Montgomery words: (rows, 8)."""
    if matrix.device.type == "cpu":
        return hash_rows_plain(matrix)
    _require(matrix, "hash_rows", 2)
    if not matrix.is_contiguous():
        raise ValueError("hash_rows: matrix must be contiguous")
    cols, rows = matrix.shape
    lib = _lib_for(matrix.device)
    out = torch.empty((rows, CELLS_OUT), dtype=torch.int32,
                      device=matrix.device)
    build.check(lib.p2_hash_rows(matrix.data_ptr(), out.data_ptr(), cols,
                                 rows, _stream(matrix.device)), "p2_hash_rows")
    hash_rows.launches += 1
    return out


hash_rows.launches = 0


def _fold_launch(lib, left, right, out, n: int, levels: int):
    """Launch the pair kernel: level 1 hashes (left[i], right[i]), i < n;
    each further level the pairs of the level below, written after it."""
    build.check(lib.p2_merkle_fold(left.data_ptr(), right.data_ptr(),
                                   out.data_ptr(), n, left.stride(0),
                                   right.stride(0), levels,
                                   _stream(out.device)), "p2_merkle_fold")
    hash_pairs.launches += 1


def hash_pairs(left, right):
    """2-to-1 compression of digest pairs: (n, 8), (n, 8) -> (n, 8).  The
    inputs may be row-strided views (a fold layer's [0::2] and [1::2]).
    One level of the pair kernel that merkle_fold runs."""
    if left.device.type == "cpu":
        return hash_pairs_plain(left, right)
    _require(left, "hash_pairs", 2)
    _require(right, "hash_pairs", 2)
    if left.shape != right.shape or left.shape[1] != CELLS_OUT:
        raise ValueError(f"hash_pairs: shapes {tuple(left.shape)}, "
                         f"{tuple(right.shape)}")
    if left.stride(1) != 1 or right.stride(1) != 1 or \
            left.device != right.device:
        raise ValueError("hash_pairs: digests must be contiguous rows on "
                         "one device")
    n = left.shape[0]
    out = torch.empty((n, CELLS_OUT), dtype=torch.int32, device=left.device)
    _fold_launch(_lib_for(left.device), left, right, out, n, 1)
    return out


hash_pairs.launches = 0


def merkle_fold(leaves):
    """Every Merkle layer above (2^k, 8) int32 leaf digests, bottom first:
    [(2^(k-1), 8), ..., (1, 8)], views into one buffer.  The launches fold
    up to FOLD_LEVELS layers each (fold_plan); each counts in
    hash_pairs.launches."""
    if leaves.device.type == "cpu":
        return merkle_fold_plain(leaves)
    _require(leaves, "merkle_fold", 2)
    k = _tree_bits(leaves, "merkle_fold")
    if leaves.stride(1) != 1:
        raise ValueError("merkle_fold: digests must be contiguous rows")
    n = 1 << k
    buf = torch.empty((n - 1, CELLS_OUT), dtype=torch.int32,
                      device=leaves.device)
    layers, off = [], 0
    for lo in range(k):
        layers.append(buf[off : off + (n >> (lo + 1))])
        off += n >> (lo + 1)
    lib = _lib_for(leaves.device)
    cur, done = leaves, 0
    for levels in fold_plan(k):
        pairs = cur.shape[0] // 2
        _fold_launch(lib, cur[0::2], cur[1::2], layers[done], pairs, levels)
        done += levels
        cur = layers[done - 1]
    return layers
