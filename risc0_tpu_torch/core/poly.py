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
    """sum_i coeffs[i] x^i; coeffs (n, 4), x (4,)."""
    tot = ext_zero()
    cur = ext_one()
    for c in np.asarray(coeffs, np.uint32):
        tot = F.add_np(tot, F.ext_mul_np(c, cur))
        cur = F.ext_mul_np(cur, x)
    return tot
