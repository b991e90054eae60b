"""ECDSA over secp256k1 (SEC 2), plainly: what the ecdsa guest's journal
must be for a given input."""

import hashlib

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


def on_curve(pt) -> bool:
    x, y = pt
    return 0 <= x < P and 0 <= y < P and (y * y - x ** 3 - 7) % P == 0


def add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % P == 0:
        return None
    if p == q:
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return (x, (lam * (p[0] - x) - p[1]) % P)


def mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def verify(message: bytes, q, r: int, s: int) -> bool:
    """Whether (r, s) signs sha256(message) under the public key q."""
    if not (0 < r < N and 0 < s < N) or not on_curve(q):
        return False
    z = int.from_bytes(hashlib.sha256(message).digest(), "big") % N
    w = pow(s, -1, N)
    pt = add(mul(z * w % N, G), mul(r * w % N, q))
    return pt is not None and pt[0] % N == r


def journal(message: bytes, q) -> bytes:
    """What the guest commits on an accepted signature: Qx, Qy (little-
    endian) and sha256(message)."""
    return (q[0].to_bytes(32, "little") + q[1].to_bytes(32, "little")
            + hashlib.sha256(message).digest())
