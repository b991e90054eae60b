"""R1CS constraint system over the BN254 scalar field (counterpart of
``risc0_tpu/groth16/r1cs.py``).

The circuit-building substrate for the in-repo Groth16 prover: signals are
linear combinations over witness variables; constraints are rank-1
(`<A,w> * <B,w> == <C,w>`).  Witness values are computed eagerly during
building, so proving is "rebuild the circuit with the new input" — there is
no separate witness solver (the reference uses a circom-generated C++
witness calculator; risc0/groth16/src/prove/docker.rs runs it in a
container).

Conventions: variable 0 is the constant ONE; public inputs are variables
1..num_public (allocated first, bound to internally computed signals at the
end via `bind_public`).
"""

from __future__ import annotations

import numpy as np

from .bn254 import R as Q  # BN254 scalar field modulus


class ConstraintError(ValueError):
    """A witness value breaks a constraint or an invariant of the circuit
    being built (an invalid seal, or a circuit that does not match)."""


class Sig:
    """A linear combination of witness variables with its current value."""

    __slots__ = ("cs", "lc", "val")

    def __init__(self, cs, lc, val):
        self.cs = cs
        self.lc = lc            # dict {var_index: coeff}
        self.val = val          # int in [0, Q)

    # -- linear ops (free) --
    def __add__(self, other):
        if isinstance(other, int):
            if other == 0:
                return self
            lc = dict(self.lc)
            lc[0] = (lc.get(0, 0) + other) % Q
            if lc[0] == 0:
                del lc[0]
            return Sig(self.cs, lc, (self.val + other) % Q)
        lc = dict(self.lc)
        for v, c in other.lc.items():
            nc = (lc.get(v, 0) + c) % Q
            if nc:
                lc[v] = nc
            elif v in lc:
                del lc[v]
        return Sig(self.cs, lc, (self.val + other.val) % Q)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, int):
            return self + (-other % Q)
        return self + other.scale(Q - 1)

    def __rsub__(self, other):
        return self.scale(Q - 1) + other

    def scale(self, k: int):
        k %= Q
        if k == 0:
            return self.cs.zero()
        return Sig(self.cs, {v: c * k % Q for v, c in self.lc.items()},
                   self.val * k % Q)

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scale(other)
        return self.cs.mul(self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return self.scale(Q - 1)

    def is_const(self):
        return all(v == 0 for v in self.lc)


class CS:
    """Constraint system.  `check=True` verifies every constraint as it is
    emitted (use in tests; adds Python-eval cost on big circuits)."""

    def __init__(self, check: bool = False):
        self.values = [1]
        self.a_rows: list = []
        self.b_rows: list = []
        self.c_rows: list = []
        self.num_public = 0
        self._pub_bound = 0
        self.check = check

    # -- variables --
    def new_var(self, value: int) -> int:
        self.values.append(value % Q)
        return len(self.values) - 1

    def witness(self, value: int) -> Sig:
        v = self.new_var(value)
        return Sig(self, {v: 1}, value % Q)

    def const(self, value: int) -> Sig:
        value %= Q
        return Sig(self, {0: value} if value else {}, value)

    def zero(self) -> Sig:
        return Sig(self, {}, 0)

    def one(self) -> Sig:
        return self.const(1)

    def alloc_public(self, value: int = 0) -> Sig:
        """Allocate a public-input variable; must precede all other vars."""
        if len(self.values) != self.num_public + 1:
            raise ConstraintError("public inputs must be allocated first")
        s = self.witness(value)
        self.num_public += 1
        return s

    def set_public(self, pub: Sig, value: int):
        (var,) = pub.lc.keys()
        self.values[var] = value % Q
        pub.val = value % Q

    def bind_public(self, pub: Sig, sig: Sig):
        """Set the public var's value from `sig` and constrain equality."""
        self.set_public(pub, sig.val)
        self.assert_eq(pub, sig)
        self._pub_bound += 1

    # -- constraints --
    def enforce(self, a: Sig, b: Sig, c: Sig):
        if self.check:
            av = sum(co * self.values[v] for v, co in a.lc.items()) % Q
            bv = sum(co * self.values[v] for v, co in b.lc.items()) % Q
            cv = sum(co * self.values[v] for v, co in c.lc.items()) % Q
            if av * bv % Q != cv:
                raise ConstraintError(
                    f"constraint violated at #{len(self.a_rows)}")
            if (av, bv, cv) != (a.val % Q, b.val % Q, c.val % Q):
                raise ConstraintError(
                    f"signal value drift at #{len(self.a_rows)}")
        self.a_rows.append(tuple(a.lc.items()))
        self.b_rows.append(tuple(b.lc.items()))
        self.c_rows.append(tuple(c.lc.items()))

    def mul(self, a: Sig, b: Sig) -> Sig:
        if a.is_const():
            return b.scale(a.val)
        if b.is_const():
            return a.scale(b.val)
        out = self.witness(a.val * b.val % Q)
        self.enforce(a, b, out)
        return out

    def assert_eq(self, a: Sig, b: Sig):
        self.enforce(a - b, self.one(), self.zero())

    def assert_zero(self, a: Sig):
        self.enforce(a, self.one(), self.zero())

    def assert_bool(self, x: Sig):
        self.enforce(x, x - 1, self.zero())

    def inverse(self, a: Sig) -> Sig:
        """Witness 1/a and constrain a * inv == 1 (fails for a == 0)."""
        if a.val == 0:
            raise ZeroDivisionError("inverse of zero signal")
        inv = self.witness(pow(a.val, Q - 2, Q))
        self.enforce(a, inv, self.one())
        return inv

    # -- bit decomposition --
    def bits(self, x: Sig, n: int) -> list[Sig]:
        """Decompose x into n little-endian bits.  NOT strict: for n >= 254
        two representations may exist; use bits_strict for transcript
        values."""
        val = x.val
        if val >= 1 << n:
            raise ConstraintError(f"value needs more than {n} bits")
        bs = []
        for i in range(n):
            b = self.witness((val >> i) & 1)
            self.assert_bool(b)
            bs.append(b)
        acc = self.zero()
        for i, b in enumerate(bs):
            acc = acc + b.scale(1 << i)
        self.assert_eq(acc, x)
        return bs

    def assert_bits_lt_const(self, bs: list[Sig], c: int):
        """Given boolean signals bs (LE), assert their value < constant c."""
        lt = self.zero()
        eq = self.one()
        for i in reversed(range(len(bs))):
            if (c >> i) & 1:
                lt = lt + self.mul(eq, 1 - bs[i])
                eq = self.mul(eq, bs[i])
            else:
                eq = self.mul(eq, 1 - bs[i])
        self.assert_eq(lt, self.one())

    def bits_strict(self, x: Sig) -> list[Sig]:
        """254-bit decomposition with a canonicity check (value < Q), so the
        bit pattern is unique (circom Num2Bits_strict equivalent)."""
        bs = self.bits(x, 254)
        self.assert_bits_lt_const(bs, Q)
        return bs

    def from_bits(self, bs: list[Sig]) -> Sig:
        acc = self.zero()
        for i, b in enumerate(bs):
            acc = acc + b.scale(1 << i)
        return acc

    def mux(self, sel_bits: list[Sig], table: list[Sig]) -> Sig:
        """table[index] where index = value of sel_bits (LE).  Table length
        must be exactly 2^len(sel_bits)."""
        k = len(sel_bits)
        if len(table) != 1 << k:
            raise ValueError(f"table of {len(table)} entries for {k} bits")
        # one-hot via product tree over bits
        hot = [self.one()]
        for b in sel_bits:
            nb = 1 - b
            new = []
            for h in hot:
                new.append(self.mul(h, nb))
            for h in hot:
                new.append(self.mul(h, b))
            hot = new  # index order: bit is the MSB of the new level
        # hot is ordered with LAST bit most significant: hot[i] corresponds to
        # index with bits (b_{k-1} ... b_0) = binary of i -> matches table
        acc = self.zero()
        for h, t in zip(hot, table):
            if t.is_const():
                acc = acc + h.scale(t.val)
            else:
                acc = acc + self.mul(h, t)
        return acc

    # -- export --
    def finalize(self):
        if self._pub_bound != self.num_public:
            raise ConstraintError("not all public inputs were bound")

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_vars(self) -> int:
        return len(self.values)

    def coo(self):
        """(rows, cols, coeffs) COO arrays for the three matrices, coeffs as
        (nnz, 4) u64 Montgomery limbs (native layout)."""
        from .native import fr_arr

        out = []
        for mat in (self.a_rows, self.b_rows, self.c_rows):
            rows, cols, coeffs = [], [], []
            for r, items in enumerate(mat):
                for v, c in items:
                    rows.append(r)
                    cols.append(v)
                    coeffs.append(c)
            out.append((np.asarray(rows, np.uint32),
                        np.asarray(cols, np.uint32),
                        fr_arr(coeffs)))
        return out

    def witness_vec(self) -> list[int]:
        return list(self.values)

    def structure_digest(self) -> bytes:
        """Hash of the constraint structure, for CRS/circuit pairing checks."""
        import hashlib

        h = hashlib.sha256()
        h.update(f"{self.num_vars},{self.num_public}".encode())
        for mat in (self.a_rows, self.b_rows, self.c_rows):
            for items in mat:
                h.update(b"|")
                for v, c in items:
                    h.update(v.to_bytes(4, "little"))
                    h.update(c.to_bytes(32, "little"))
        return h.digest()
