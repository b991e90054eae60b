"""BN254 (alt_bn128) pairing, from first principles (counterpart of
``risc0_tpu/groth16/bn254.py``).

Host-side verification math for Groth16 receipts (reference
risc0/groth16/src/verifier.rs uses ark-bn254; this is an independent
textbook implementation: affine Miller loop on the sextic twist embedded in
Fq12 = Fq2[w]/(w^6 - xi), xi = 9 + u, plus a plain-pow final
exponentiation).  Python ints; speed is adequate for receipt verification.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2 + 1)
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    a0, a1 = a
    d = pow(a0 * a0 + a1 * a1, P - 2, P)
    return (a0 * d % P, (-a1) * d % P)


def f2_pow(a, e):
    out = F2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_mul(a, a)
        e >>= 1
    return out


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)   # the sextic twist constant

# ---------------------------------------------------------------------------
# Fq12 = Fq2[w]/(w^6 - xi): 6-tuples of Fq2 coefficients
# ---------------------------------------------------------------------------

F12_ZERO = (F2_ZERO,) * 6
F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5


def f12_from_fq(x):
    return ((x % P, 0),) + (F2_ZERO,) * 5


def f12_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f12_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f12_neg(a):
    return tuple(f2_neg(x) for x in a)


def f12_mul(a, b):
    acc = [F2_ZERO] * 11
    for i, ai in enumerate(a):
        if ai == F2_ZERO:
            continue
        for j, bj in enumerate(b):
            if bj == F2_ZERO:
                continue
            acc[i + j] = f2_add(acc[i + j], f2_mul(ai, bj))
    out = list(acc[:6])
    for k in range(6, 11):           # w^k = xi * w^(k-6)
        out[k - 6] = f2_add(out[k - 6], f2_mul(acc[k], XI))
    return tuple(out)


def f12_pow(a, e):
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_mul(a, a)
        e >>= 1
    return out


def f12_inv(a):
    # Gaussian elimination on the 6x6 multiplication matrix is overkill;
    # use the norm tower: inv(a) = conj_chain / norm via a^(p^12 - 2) is
    # too slow -- instead solve via extended tower: represent as
    # c0 + c1*w with c0,c1 in Fq6=Fq2[w^2]?  Simpler: linear solve.
    # a * x = 1: build the matrix of mul-by-a over the 6-dim Fq2 module.
    cols = []
    for i in range(6):
        basis = tuple(F2_ONE if j == i else F2_ZERO for j in range(6))
        cols.append(f12_mul(a, basis))
    # solve sum_i x_i * cols[i] = (1,0,0,0,0,0) over Fq2
    m = [[cols[i][r] for i in range(6)] for r in range(6)]
    rhs = [F2_ONE if r == 0 else F2_ZERO for r in range(6)]
    for c in range(6):
        piv = next(r for r in range(c, 6) if m[r][c] != F2_ZERO)
        m[c], m[piv] = m[piv], m[c]
        rhs[c], rhs[piv] = rhs[piv], rhs[c]
        inv = f2_inv(m[c][c])
        m[c] = [f2_mul(x, inv) for x in m[c]]
        rhs[c] = f2_mul(rhs[c], inv)
        for r in range(6):
            if r != c and m[r][c] != F2_ZERO:
                f = m[r][c]
                m[r] = [f2_sub(x, f2_mul(f, y)) for x, y in zip(m[r], m[c])]
                rhs[r] = f2_sub(rhs[r], f2_mul(f, rhs[c]))
    return tuple(rhs)


def f12_frobenius(a):
    """a^p: coefficient conjugation times w^i Frobenius twists."""
    return tuple(f2_mul(f2_conj(c), _FROB_W[i]) for i, c in enumerate(a))


_FROB_W = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]

# ---------------------------------------------------------------------------
# curve points
# ---------------------------------------------------------------------------

CURVE_B = 3
TWIST_B = f2_mul((3, 0), f2_inv(XI))
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - CURVE_B) % P == 0


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_mul(y, y),
                  f2_add(f2_mul(f2_mul(x, x), x), TWIST_B)) == F2_ZERO


def g1_neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(pt, k):
    out = None
    while k:
        if k & 1:
            out = g1_add(out, pt)
        pt = g1_add(pt, pt)
        k >>= 1
    return out


# ---------------------------------------------------------------------------
# pairing (optimal ate), G2 embedded into E(Fq12) via the twist map
# ---------------------------------------------------------------------------

ATE_LOOP = 29793968203157093288  # 6x + 2, x = 4965661367192848881


def _twist(q):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x w^2, y w^3)."""
    x, y = q
    xx = (F2_ZERO, F2_ZERO, x, F2_ZERO, F2_ZERO, F2_ZERO)
    yy = (F2_ZERO, F2_ZERO, F2_ZERO, y, F2_ZERO, F2_ZERO)
    return (xx, yy)


def _e12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f12_add(y1, y2) == F12_ZERO:
            return None
        lam = f12_mul(f12_mul(f12_mul(f12_from_fq(3), x1), x1),
                      f12_inv(f12_add(y1, y1)))
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_mul(lam, lam), x1), x2)
    return (x3, f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1))


def _line(t, q, p_xy):
    """Evaluation at embedded P of the line through T and Q (or tangent)."""
    xp, yp = p_xy
    x1, y1 = t
    if q is not None and t[0] == q[0] and t[1] != q[1]:
        # vertical line x - x1
        return f12_sub(xp, x1)
    if q is None or (t[0] == q[0] and t[1] == q[1]):
        lam = f12_mul(f12_mul(f12_mul(f12_from_fq(3), x1), x1),
                      f12_inv(f12_add(y1, y1)))
    else:
        lam = f12_mul(f12_sub(q[1], y1), f12_inv(f12_sub(q[0], x1)))
    return f12_sub(f12_sub(yp, y1), f12_mul(lam, f12_sub(xp, x1)))


def _frob_point(pt):
    return (f12_frobenius(pt[0]), f12_frobenius(pt[1]))


def miller_loop(q, p):
    """Optimal ate Miller value f_{6x+2,Q}(P) * extra lines; q: G2 affine
    over Fq2, p: G1 affine over Fq."""
    if q is None or p is None:
        return F12_ONE
    Q = _twist(q)
    Pemb = (f12_from_fq(p[0]), f12_from_fq(p[1]))
    T = Q
    f = F12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_mul(f12_mul(f, f), _line(T, None, Pemb))
        T = _e12_add(T, T)
        if bit == "1":
            f = f12_mul(f, _line(T, Q, Pemb))
            T = _e12_add(T, Q)
    q1 = _frob_point(Q)
    q2 = _frob_point(q1)
    q2 = (q2[0], f12_neg(q2[1]))
    f = f12_mul(f, _line(T, q1, Pemb))
    T = _e12_add(T, q1)
    f = f12_mul(f, _line(T, q2, Pemb))
    return f


def final_exponentiation(f):
    """f^((p^12 - 1) / r); easy part explicit, hard part by plain pow."""
    # easy: f^(p^6 - 1) = conj(f) / f  (p^6 power = conjugation of w-odd
    # coeffs); do it by pow for simplicity and correctness
    f = f12_mul(f12_pow(f, P**6 - 1), F12_ONE)
    f = f12_pow(f, P**2 + 1)
    return f12_pow(f, (P**4 - P**2 + 1) // R)


def multi_pairing_is_one(pairs):
    """prod e(P_i, Q_i) == 1, sharing one final exponentiation."""
    f = F12_ONE
    for p1, q2 in pairs:
        f = f12_mul(f, miller_loop(q2, p1))
    return final_exponentiation(f) == F12_ONE


def pairing(p1, q2):
    return final_exponentiation(miller_loop(q2, p1))
