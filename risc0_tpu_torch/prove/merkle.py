"""Merkle tree prover (counterpart of ``risc0_tpu/prove/merkle.py``;
reference risc0/zkp/src/prove/merkle.rs).

Layers live on the device; the top layer (the largest with <= queries
nodes) is written wholesale into the seal, so queries only need paths
below it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import to_numpy
from ..hal import torch_hal as hal
from ..hash.suite import POSEIDON2


def merkle_params(row_size: int, queries: int):
    layers = row_size.bit_length() - 1
    if 1 << layers != row_size:
        raise ValueError(f"row count {row_size} is not a power of two")
    top_layer = 0
    for i in range(1, layers):
        if (1 << i) > queries:
            break
        top_layer = i
    return layers, 1 << top_layer


class MerkleTreeProver:
    """matrix: (cols, rows) int32 device tensor; leaf r hashes column r
    under `suite`."""

    def __init__(self, matrix, queries: int = 50, suite=POSEIDON2,
                 layers=None):
        self.matrix = matrix
        self.cols, self.rows = matrix.shape
        self.num_layers, self.top_size = merkle_params(self.rows, queries)
        # layers[0] = leaves (rows, 8) ... layers[-1] = root (1, 8)
        self.layers = layers if layers is not None \
            else hal.merkle_layers(matrix, suite)
        self._root = None

    @property
    def root(self) -> np.ndarray:
        if self._root is None:
            self._root = to_numpy(self.layers[-1][0])
        return self._root

    def commit(self, iop):
        """Write the top layer (virtual heap indices [top_size,
        2*top_size)) and commit the root; one readback covers both."""
        top_level = self.num_layers - (self.top_size.bit_length() - 1)
        fused = to_numpy(torch.cat([self.layers[top_level].reshape(-1),
                                    self.layers[-1].reshape(-1)]))
        self._root = fused[self.top_size * 8 :]
        iop.write_digests(fused[: self.top_size * 8])
        iop.commit(self._root)

    def prefetch(self, positions) -> "PrefetchedProofs":
        """Gather every query opening (columns and uncle digests of all
        levels) with one device gather per level and one readback; the
        query positions are all drawn before any opening is written."""
        pos = np.asarray(positions, np.int64)
        dev = self.matrix.device
        q = len(pos)
        parts = [self.matrix[:, torch.as_tensor(pos, device=dev)].reshape(-1)]
        v = pos + self.rows
        level = 0
        while (v >= 2 * self.top_size).any():
            idxs = (v ^ 1) - (self.rows >> level)
            parts.append(self.layers[level][
                torch.as_tensor(idxs, device=dev)].reshape(-1))
            v //= 2
            level += 1
        flat = to_numpy(torch.cat(parts))
        cols = flat[: self.cols * q].reshape(self.cols, q)
        off = self.cols * q
        uncles = []
        for _ in parts[1:]:
            uncles.append(flat[off : off + q * 8].reshape(q, 8))
            off += q * 8
        return PrefetchedProofs(cols, uncles)


class PrefetchedProofs:
    def __init__(self, cols, uncles):
        self.cols = cols
        self.uncles = uncles

    def write(self, iop, qi: int):
        iop.write_field_elems(self.cols[:, qi])
        for level in self.uncles:
            iop.write_digests(level[qi])
