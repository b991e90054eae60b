"""R1CS gadgets for the stark_verify circuit (counterpart of
``risc0_tpu/groth16/gadgets.py``).

BabyBear arithmetic is emulated inside the BN254 scalar field with lazy
reduction: a `BB` value carries its exact integer bound; additions and
multiplications stay unreduced until the bound approaches the Fr modulus,
then a witnessed quotient/remainder reduction (with bit range checks)
brings it back under 2^31.  This mirrors what the reference's circom
stark_verify components do with their own BabyBear templates
(groth16_proof/groth16/risc0.circom), designed independently here around
bound tracking.

Poseidon254 (t=3, alpha=8) is native Fr arithmetic: 3 constraints per
S-box, linear MDS/round constants — the reason the identity_p254 wrap
re-commits the receipt under this hash.
"""

from __future__ import annotations

from ..field import P  # BabyBear modulus
from ..hash import poseidon254 as p254
from .r1cs import CS, ConstraintError, Q, Sig

MAXB = 1 << 250          # bound ceiling before forced reduction
_P_BITS = 31


class BB:
    """Emulated BabyBear value: Fr signal + exact integer bound (value is
    meaningful mod P; the signal's integer value is <= bound < Q)."""

    __slots__ = ("sig", "bound")

    def __init__(self, sig: Sig, bound: int):
        if bound >= Q:
            raise ConstraintError("BB bound overflow")
        self.sig = sig
        self.bound = bound

    @property
    def val(self) -> int:
        """Canonical BabyBear value."""
        return self.sig.val % P


def bb_const(cs: CS, v: int) -> BB:
    v %= P
    return BB(cs.const(v), v)


def bb_input(cs: CS, value: int) -> BB:
    """Witness a canonical BabyBear element (< P), range-checked.  This is
    the `read_field_elems` validity check (verify/read_iop.rs rejects
    non-canonical seal words)."""
    if not 0 <= value < P:
        raise ConstraintError(f"{value} is not a BabyBear element")
    sig = cs.witness(value)
    assert_canonical(cs, sig)
    return BB(sig, P - 1)


def assert_canonical(cs: CS, sig: Sig):
    """Assert sig's value is in [0, P-1].  P = 15*2^27 + 1: decompose into
    31 bits (h = bits 27..30, l = low 27) and require h == 15 -> l == 0,
    which admits exactly [0, 15*2^27] = [0, P-1]."""
    bits = cs.bits(sig, _P_BITS)
    l = cs.zero()
    for i in range(27):
        l = l + bits[i].scale(1 << i)
    and4 = cs.mul(cs.mul(bits[27], bits[28]), cs.mul(bits[29], bits[30]))
    cs.enforce(and4, l, cs.zero())


def bb_add(a: BB, b: BB) -> BB:
    # long add chains (the recursion poly_ext IR) grow bounds without any
    # interleaved mul to force a fit — auto-reduce before Q overflows
    if a.bound + b.bound >= MAXB:
        cs = a.sig.cs
        if a.bound >= b.bound:
            a = bb_reduce(cs, a)
        if a.bound + b.bound >= MAXB:
            b = bb_reduce(cs, b)
    return BB(a.sig + b.sig, a.bound + b.bound)


def bb_sub(a: BB, b: BB) -> BB:
    """a - b, lifted non-negative by a multiple of P covering b's bound."""
    if a.bound + b.bound + P >= MAXB:
        cs = a.sig.cs
        if a.bound >= b.bound:
            a = bb_reduce(cs, a)
        if a.bound + b.bound + P >= MAXB:
            b = bb_reduce(cs, b)
    pad = (b.bound // P + 1) * P
    return BB(a.sig + pad - b.sig, a.bound + pad)


def bb_scale(a: BB, c: int) -> BB:
    """Multiply by a standard-form constant (free)."""
    c %= P
    if c and a.bound * c >= MAXB:
        a = bb_reduce(a.sig.cs, a)
    return BB(a.sig.scale(c), a.bound * c)


def bb_reduce(cs: CS, a: BB, canonical: bool = False) -> BB:
    """Witness q, r with a = q*P + r and range checks; returns r."""
    val = a.sig.val
    q_val, r_val = divmod(val, P)
    q = cs.witness(q_val)
    r = cs.witness(r_val)
    q_bits = max(1, (a.bound // P).bit_length())
    cs.bits(q, q_bits)
    if canonical:
        assert_canonical(cs, r)
        r_bound = P - 1
    else:
        cs.bits(r, _P_BITS)
        r_bound = (1 << _P_BITS) - 1
    cs.assert_eq(a.sig, q.scale(P) + r)
    return BB(r, r_bound)


def bb_canon(cs: CS, a: BB) -> BB:
    if a.bound <= P - 1:
        return a
    return bb_reduce(cs, a, canonical=True)


def bb_fit(cs: CS, a: BB, need: int) -> BB:
    """Reduce a if multiplying it against a bound of `need` would overflow."""
    if a.bound * need >= MAXB:
        return bb_reduce(cs, a)
    return a


def bb_mul(cs: CS, a: BB, b: BB) -> BB:
    if a.bound * b.bound >= MAXB:
        if a.bound >= b.bound:
            a = bb_reduce(cs, a)
        if a.bound * b.bound >= MAXB:
            b = bb_reduce(cs, b)
    return BB(cs.mul(a.sig, b.sig), a.bound * b.bound)


def bb_assert_eq(cs: CS, a: BB, b: BB):
    """Assert a == b (mod P): witness m with a + pad - b == m*P."""
    pad = (b.bound // P + 1) * P
    diff = a.sig + pad - b.sig
    diff_val = diff.val
    if diff_val % P:
        raise ConstraintError("bb_assert_eq on unequal values")
    m = cs.witness(diff_val // P)
    m_bits = max(1, ((a.bound + pad) // P).bit_length())
    cs.bits(m, m_bits)
    cs.assert_eq(diff, m.scale(P))


def bb_assert_zero(cs: CS, a: BB):
    bb_assert_eq(cs, a, bb_const(cs, 0))


# ---------------------------------------------------------------------------
# Fp4 = BabyBear[x]/(x^4 + 11): lists of 4 BB (field.py ext_mul_np uses
# NBETA = P - 11 in the reduction fold)
# ---------------------------------------------------------------------------

NBETA = P - 11


def ext_const(cs: CS, vals) -> list[BB]:
    return [bb_const(cs, int(v)) for v in vals]


def ext_zero(cs: CS) -> list[BB]:
    return ext_const(cs, [0, 0, 0, 0])


def ext_one(cs: CS) -> list[BB]:
    return ext_const(cs, [1, 0, 0, 0])


def ext_from_base(b: BB, cs: CS) -> list[BB]:
    return [b, bb_const(cs, 0), bb_const(cs, 0), bb_const(cs, 0)]


def ext_add(a, b) -> list[BB]:
    return [bb_add(x, y) for x, y in zip(a, b)]


def ext_sub(a, b) -> list[BB]:
    return [bb_sub(x, y) for x, y in zip(a, b)]


def ext_mul(cs: CS, a, b) -> list[BB]:
    """field.py:126-137 quartic multiply with NBETA fold."""
    # pre-fit operands so every cross product is valid
    max_a = max(x.bound for x in a)
    max_b = max(x.bound for x in b)
    # the NBETA-scaled sums add ~3 products * NBETA; demand headroom
    if max_a * max_b * NBETA * 4 >= MAXB:
        a = [bb_reduce(cs, x) if x.bound > (1 << 31) else x for x in a]
        b = [bb_reduce(cs, x) if x.bound > (1 << 31) else x for x in b]
        max_a = max(x.bound for x in a)
        max_b = max(x.bound for x in b)
        if max_a * max_b * NBETA * 4 >= MAXB:
            raise AssertionError("ext_mul bound overflow after reduce")
    m = lambda x, y: bb_mul(cs, x, y)
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = bb_add(m(a0, b0), bb_scale(
        bb_add(bb_add(m(a1, b3), m(a2, b2)), m(a3, b1)), NBETA))
    c1 = bb_add(bb_add(m(a0, b1), m(a1, b0)),
                bb_scale(bb_add(m(a2, b3), m(a3, b2)), NBETA))
    c2 = bb_add(bb_add(m(a0, b2), bb_add(m(a1, b1), m(a2, b0))),
                bb_scale(m(a3, b3), NBETA))
    c3 = bb_add(bb_add(m(a0, b3), m(a1, b2)), bb_add(m(a2, b1), m(a3, b0)))
    return [c0, c1, c2, c3]


def ext_mul_base(cs: CS, a, b: BB) -> list[BB]:
    return [bb_mul(cs, x, b) for x in a]


def ext_scale(a, c: int) -> list[BB]:
    return [bb_scale(x, c) for x in a]


def ext_reduce(cs: CS, a, canonical: bool = False) -> list[BB]:
    return [bb_reduce(cs, x, canonical) if x.bound > P - 1 else x for x in a]


def ext_assert_eq(cs: CS, a, b):
    for x, y in zip(a, b):
        bb_assert_eq(cs, x, y)


def ext_inv(cs: CS, a) -> list[BB]:
    """Witness the Fp4 inverse (computed host-side) and constrain
    a * ainv == 1."""
    import numpy as np

    from .. import field as F

    vals = np.array([F.s_encode(x.val) for x in a], np.uint32)
    if not vals.any():
        raise ZeroDivisionError("ext_inv of zero")
    inv_vals = F.decode_np(F.ext_inv_np(vals))
    ainv = [bb_input(cs, int(v)) for v in inv_vals]
    prod = ext_mul(cs, a, ainv)
    ext_assert_eq(cs, prod, ext_one(cs))
    return ainv


def ext_pow2k(cs: CS, a, k: int) -> list[BB]:
    """a^(2^k) by repeated squaring."""
    for _ in range(k):
        a = ext_mul(cs, a, a)
    return a


def poly_eval_ext(cs: CS, coeffs, x) -> list[BB]:
    """Horner evaluation; coeffs are ext values, x ext."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = ext_add(ext_mul(cs, acc, x), c)
    return acc


# ---------------------------------------------------------------------------
# Poseidon254 permutation / sponge / Fiat-Shamir RNG
# ---------------------------------------------------------------------------


def p254_permute(cs: CS, cells: list[Sig]) -> list[Sig]:
    rc, mds = p254._consts()
    cells = list(cells)
    for r in range(p254.ROUNDS_TOT):
        full = (r < p254.ROUNDS_HALF_FULL
                or r >= p254.ROUNDS_HALF_FULL + p254.ROUNDS_PARTIAL)
        base = r * p254.CELLS
        cells = [c + rc[base + i] for i, c in enumerate(cells)]
        if full:
            cells = [_sbox8(cs, c) for c in cells]
        else:
            cells[0] = _sbox8(cs, cells[0])
        cells = [
            sum((cells[j].scale(mds[i * p254.CELLS + j])
                 for j in range(p254.CELLS)), cs.zero())
            for i in range(p254.CELLS)
        ]
    return cells


def _sbox8(cs: CS, x: Sig) -> Sig:
    x2 = cs.mul(x, x)
    x4 = cs.mul(x2, x2)
    return cs.mul(x4, x4)


def p254_hash_pair(cs: CS, a: Sig, b: Sig) -> Sig:
    return p254_permute(cs, [cs.zero(), a, b])[0]


def p254_hash_slice(cs: CS, elems: list[BB]) -> Sig:
    """unpadded_hash over canonical BabyBear values, 8 packed per Fr with
    radix P (hash/poseidon254.py:97-124)."""
    for e in elems:
        if e.bound > P - 1:
            raise ConstraintError("hash input must be canonical")
    cells = [cs.zero(), cs.zero(), cs.zero()]
    mul_c = 1
    idx, count = 1, 0
    for e in elems:
        cells[idx] = cells[idx] + e.sig.scale(mul_c)
        mul_c = mul_c * P % Q
        count += 1
        if count == 8:
            mul_c = 1
            count = 0
            idx += 1
        if idx == 3:
            cells = p254_permute(cs, cells)
            cells[1] = cs.zero()
            cells[2] = cs.zero()
            idx = 1
    if idx != 1 or count != 0:
        cells = p254_permute(cs, cells)
    return cells[0]


class RngGadget:
    """Poseidon254Rng in-circuit (hash/poseidon254.py:189-217)."""

    def __init__(self, cs: CS):
        self.cs = cs
        self.cells = [cs.zero(), cs.zero(), cs.zero()]

    def mix(self, digest: Sig):
        self.cells[1] = self.cells[1] + digest
        self.cells = p254_permute(self.cs, self.cells)

    def _draw_source_bits(self) -> list[Sig]:
        """Strict 254-bit decomposition of cells[2], then permute."""
        bits = self.cs.bits_strict(self.cells[2])
        self.cells = p254_permute(self.cs, self.cells)
        return bits

    def random_bits(self, nbits: int) -> list[Sig]:
        return self._draw_source_bits()[:nbits]

    def random_elem(self) -> BB:
        """low-160 bits of the draw, mod P, as a canonical BB."""
        cs = self.cs
        bits = self._draw_source_bits()
        low = cs.zero()
        low_val = 0
        for i in range(160):
            low = low + bits[i].scale(1 << i)
            low_val += bits[i].val << i
        q_val, r_val = divmod(low_val, P)
        q = cs.witness(q_val)
        cs.bits(q, 130)
        r = cs.witness(r_val)
        assert_canonical(cs, r)
        cs.assert_eq(low, q.scale(P) + r)
        return BB(r, P - 1)

    def random_ext_elem(self) -> list[BB]:
        return [self.random_elem() for _ in range(4)]
