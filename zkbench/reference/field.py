"""BabyBear (p = 15 * 2^27 + 1) and its degree-4 extension x^4 = -11,
in plain Python integers and canonical form.

Seals carry Montgomery words (R = 2^32); `decode` turns one into the value
it stands for, and everything here works on values.  An extension element
is a tuple of four coefficients (c0 + c1 x + c2 x^2 + c3 x^3).
"""

P = 15 * (1 << 27) + 1
R_INV = pow(1 << 32, P - 2, P)
BETA = 11
# a primitive 2^27-th root of unity (risc0 core/field/baby_bear.rs ROU_FWD)
ROOT_27 = 137

ZERO = (0, 0, 0, 0)
ONE = (1, 0, 0, 0)


def decode(word: int) -> int:
    """The value of a Montgomery word."""
    return int(word) * R_INV % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, P - 2, P)


def rou(po2: int) -> int:
    """The primitive 2^po2-th root of unity of risc0's table."""
    return pow(ROOT_27, 1 << (27 - po2), P)


def rou_inv(po2: int) -> int:
    return inv(rou(po2))


def ext(a: int) -> tuple:
    return (a % P, 0, 0, 0)


def eadd(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P,
            (a[3] + b[3]) % P)


def esub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P,
            (a[3] - b[3]) % P)


def escale(a, s: int):
    return (a[0] * s % P, a[1] * s % P, a[2] * s % P, a[3] * s % P)


def emul(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return ((a0 * b0 - BETA * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
            (a0 * b1 + a1 * b0 - BETA * (a2 * b3 + a3 * b2)) % P,
            (a0 * b2 + a1 * b1 + a2 * b0 - BETA * a3 * b3) % P,
            (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P)


def epow(a, e: int):
    out = ONE
    while e:
        if e & 1:
            out = emul(out, a)
        a = emul(a, a)
        e >>= 1
    return out


def einv(a):
    """a^(p^4 - 2): the inverse in the field of p^4 elements."""
    if a == ZERO:
        raise ZeroDivisionError("inverse of zero")
    return epow(a, P ** 4 - 2)


def poly_eval(coeffs, x):
    """sum_i coeffs[i] x^i over extension coefficients, by Horner."""
    acc = ZERO
    for c in reversed(coeffs):
        acc = eadd(emul(acc, x), c)
    return acc
