"""Host polynomial utilities over F_p4 (reference: risc0/zkp/src/core/poly.rs).

Operates on numpy arrays of ext elements (shape (..., 4), Montgomery form).
These run on tiny inputs (the verifier's checks).
"""

from __future__ import annotations

import numpy as np

from .. import field as F


def ext_zero():
    return np.zeros(4, np.uint32)


def ext_one():
    out = np.zeros(4, np.uint32)
    out[0] = F.R % F.P
    return out


def poly_eval(coeffs, x):
    """sum_i coeffs[i] x^i; coeffs (n, 4), x (4,).  The powers of x are
    built by doubling and the terms summed in uint64, reduced once."""
    coeffs = np.asarray(coeffs, np.uint32).reshape(-1, 4)
    if len(coeffs) == 0:
        return ext_zero()
    terms = F.ext_mul_np(coeffs, F.ext_powers_np(x, len(coeffs)))
    return (terms.astype(np.uint64).sum(0) % F.P).astype(np.uint32)
