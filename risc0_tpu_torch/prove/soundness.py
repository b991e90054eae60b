"""Soundness calculators (reference: risc0/zkp/src/prove/soundness.rs).

Computes proven and conjectured (toy-model) security bits from the tap set and
the final FRI polynomial size, logged with each proof like the reference
(prove/prover.rs:381-387).  All math in float32 to mirror the reference's f32
arithmetic.
"""

from __future__ import annotations

import math

import numpy as np

from .. import field as F

INV_RATE = 4
QUERIES = 50
FRI_FOLD = 16
FRI_MIN_DEGREE = 256
EXT_SIZE = 4
M = np.float32(16.0)
RHO = np.float32(1.0 / INV_RATE)


class _Params:
    def __init__(self, taps, coeffs_size: int):
        f = np.float32
        self.w_accum = f(taps.group_size(0))
        self.n_trace_polys = f(taps.group_size(0) + taps.group_size(1)
                               + taps.group_size(2))
        self.max_degree = f(5.0)
        self.num_segment_polynomials = self.max_degree - f(1.0)
        self.biggest_combo = f(max(len(c) for c in taps.combos))
        self.ext_field_size = f(F.P) ** f(EXT_SIZE)
        self.trace_domain_size = f(coeffs_size // EXT_SIZE)
        self.lde_domain_size = self.trace_domain_size * f(INV_RATE)
        n, size = 0, coeffs_size
        while size // EXT_SIZE > FRI_MIN_DEGREE:
            size //= FRI_FOLD
            n += 1
        self.num_folding_rounds = n

    def plonk_plookup_error(self):
        return (self.w_accum / np.float32(EXT_SIZE)
                * (self.max_degree - np.float32(2.0)) * self.trace_domain_size
                / self.ext_field_size)

    def e_proximity_gap_proven(self):
        return ((M + np.float32(0.5)) ** 7
                / (np.float32(3.0) * np.sqrt(RHO) ** 3)
                * (self.lde_domain_size ** 2 / self.ext_field_size))

    def e_fri_constant(self, e_proximity_gap):
        first = (self.n_trace_polys + self.num_segment_polynomials
                 - np.float32(0.5)) * e_proximity_gap
        num = (np.float32(2.0) * M + np.float32(1.0)) \
            * (self.lde_domain_size + np.float32(1.0)) \
            * np.float32(FRI_FOLD * self.num_folding_rounds)
        second = num / (np.sqrt(RHO) * self.ext_field_size)
        return first + second

    def e_fri(self, theta, e_proximity_gap):
        return self.e_fri_constant(e_proximity_gap) + \
            (np.float32(1.0) - theta) ** QUERIES

    def e_deep_ali(self, l_plus):
        e_ali = l_plus * self.n_trace_polys / self.ext_field_size
        h_plus = self.trace_domain_size + self.biggest_combo
        num = self.num_segment_polynomials * (h_plus - np.float32(1.0)) \
            + (self.trace_domain_size - np.float32(1.0))
        den = self.ext_field_size - self.trace_domain_size - self.lde_domain_size
        return e_ali + l_plus * num / den


def _soundness_error(p: _Params, theta, e_proximity_gap, l_plus) -> float:
    total = p.plonk_plookup_error() + p.e_fri(theta, e_proximity_gap) \
        + p.e_deep_ali(l_plus)
    return abs(math.log2(float(total)))


def proven(taps, coeffs_size: int) -> float:
    """Proven soundness bits (soundness.rs:17-33)."""
    p = _Params(taps, coeffs_size)
    alpha = (np.float32(1.0) + np.float32(1.0) / (np.float32(2.0) * M)) * np.sqrt(RHO)
    theta = np.float32(1.0) - alpha
    rho_plus = (p.trace_domain_size + p.biggest_combo) / p.lde_domain_size
    m_plus = np.ceil(np.float32(1.0) /
                     (p.biggest_combo * (alpha / np.sqrt(rho_plus) - np.float32(1.0))))
    l_plus = (m_plus + np.float32(0.5)) / np.sqrt(rho_plus)
    return _soundness_error(p, theta, p.e_proximity_gap_proven(), l_plus)


def toy_model_security(taps, coeffs_size: int) -> float:
    """Toy-model conjectured bits (soundness.rs:48-61); ~98 for rv32im."""
    p = _Params(taps, coeffs_size)
    total = p.plonk_plookup_error() + np.float32(1.0) / p.ext_field_size \
        + RHO ** QUERIES
    return abs(math.log2(float(total)))
