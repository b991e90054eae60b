"""FRI low-degree proof, prover side (counterpart of
``risc0_tpu/prove/fri.py``; reference risc0/zkp/src/prove/fri.rs).

Rounds of [4x LDE -> Merkle commit -> draw fold mix -> fold x16] until the
polynomial has <= 256 coefficients, then 50 queries with Merkle openings.
"""

from __future__ import annotations

import torch

from .. import perf
from ..convert import to_numpy
from ..core import ntt
from ..hal import torch_hal as hal
from ..hal.cuda import poseidon2 as kp2
from .merkle import MerkleTreeProver

INV_RATE = 4
FRI_FOLD = 16
FRI_MIN_DEGREE = 256
QUERIES = 50


class _ProveRound:
    def __init__(self, iop, coeffs):
        # coeffs: (4, size) planar bit-reversed ext poly
        self.domain = coeffs.shape[1] * INV_RATE
        evaluated = hal.expand_evaluate(coeffs, 2)  # (4, domain)
        matrix = evaluated.reshape(FRI_FOLD * 4, self.domain // FRI_FOLD)
        self.merkle = MerkleTreeProver(matrix, QUERIES)
        self.merkle.commit(iop)
        self.coeffs = hal.fri_fold(coeffs, iop.random_ext_elem())


def _final_and_digest(coeffs):
    """Bit-reverse the final coefficients and sponge-hash them (one row of
    4*size words through the row-hash kernel); one readback returns
    [final.ravel() | digest(8)]."""
    final = ntt.bit_reverse(coeffs).contiguous()
    digest = kp2.hash_rows(final.reshape(-1, 1))[0]
    return to_numpy(torch.cat([final.reshape(-1), digest]))


def fri_prove(iop, final_poly_coeffs, inner):
    """final_poly_coeffs: (4, cycles) planar bit-reversed ext poly.
    `inner(positions)` returns a writer of the caller's per-query openings
    (group Merkle proofs).  Mirrors reference fri.rs:86-126."""
    coeffs = final_poly_coeffs
    orig_domain = coeffs.shape[1] * INV_RATE
    rounds = []
    with perf.scope("rounds"):
        while coeffs.shape[1] > FRI_MIN_DEGREE:
            rnd = _ProveRound(iop, coeffs)
            rounds.append(rnd)
            coeffs = rnd.coeffs
        flat = _final_and_digest(coeffs)
        final = flat[:-8].reshape(tuple(coeffs.shape))
        digest = flat[-8:]
    iop.write_field_elems(final)
    iop.commit(digest)

    # the rng advances only on draws, so drawing every position up front
    # matches the reference's interleaved schedule
    positions = [iop.random_bits(orig_domain.bit_length() - 1)
                 for _ in range(QUERIES)]
    round_positions = []
    cur = positions
    for rnd in rounds:
        cur = [p % (rnd.domain // FRI_FOLD) for p in cur]
        round_positions.append(cur)
    with perf.scope("round_prefetch"):
        prefetched = [rnd.merkle.prefetch(ps)
                      for rnd, ps in zip(rounds, round_positions)]
    with perf.scope("inner_prefetch"):
        inner_prefetched = inner(positions)
    with perf.scope("query_write"):
        for qi in range(QUERIES):
            inner_prefetched(iop, qi)
            for pf in prefetched:
                pf.write(iop, qi)
