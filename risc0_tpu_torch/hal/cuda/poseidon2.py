"""Poseidon2 row hashing and pair compression: CUDA kernels and their plain
torch versions (counterpart of ``risc0_tpu/hal/pallas/poseidon2.py``).

``hash_rows`` and ``hash_pairs`` take the plain version only for tensors
on the CPU; for a CUDA tensor they launch the kernel in
``risc0_tpu_torch/csrc/poseidon2.cu`` or raise.  Each wrapper counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...hash.poseidon2 import (CELLS, CELLS_OUT, CELLS_RATE, MINT_MONT,
                               RC_MONT, permute)
from . import build

_constants_set: set = set()


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
        rc = np.ascontiguousarray(RC_MONT.ravel())
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


def hash_pairs(left, right):
    """2-to-1 compression of digest pairs: (n, 8), (n, 8) -> (n, 8).  The
    inputs may be row-strided views (a fold layer's [0::2] and [1::2])."""
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
    lib = _lib_for(left.device)
    out = torch.empty((n, CELLS_OUT), dtype=torch.int32, device=left.device)
    build.check(lib.p2_hash_pairs(left.data_ptr(), right.data_ptr(),
                                  out.data_ptr(), n, left.stride(0),
                                  right.stride(0), _stream(left.device)),
                "p2_hash_pairs")
    hash_pairs.launches += 1
    return out


hash_pairs.launches = 0
