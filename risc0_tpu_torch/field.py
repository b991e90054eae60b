"""BabyBear field (p = 15·2^27 + 1) and its degree-4 extension, on torch.

Counterpart of ``risc0_tpu/field.py``.  Element tensors hold canonical
Montgomery words (R = 2^32) as ``torch.int32``: every canonical word is
below P = 0x78000001 < 2^31, so it is a non-negative int32.  Eager torch
has no arithmetic on ``torch.uint32``, so the device ops below widen to
``int64`` where a product needs it and return ``int32``.  The CUDA kernels
read the same buffers as ``uint32_t*``.

The Montgomery product is computed as ``(a*b mod P) * R^-1 mod P`` in
int64: the reference's REDC (``M*low`` and ``o + red*P``) overflows a
signed int64, and the canonical result is the same either way.

The numpy host helpers (suffix ``_np``) and the python-int scalar helpers
(prefix ``s_``) are copies of the reference's, so the transcript, the
verifier and the tests share one definition without importing jax.
"""

from __future__ import annotations

import numpy as np
import torch

P = 15 * (1 << 27) + 1  # 2013265921 == 0x78000001
M = 0x88000001          # P^{-1} mod 2^32 (REDC constant)
R = (1 << 32) % P       # Montgomery R mod P = 268435454
R2 = (R * R) % P        # encodes into Montgomery form
R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod P
INVALID = 0xFFFFFFFF
BETA = 11
NBETA = P - 11
EXT_SIZE = 4
MAX_ROU_PO2 = 27

# Forward/reverse roots of unity per power of two, standard form
# (reference baby_bear.rs:178-200).
ROU_FWD = [
    1, 2013265920, 284861408, 1801542727, 567209306, 740045640, 918899846,
    1881002012, 1453957774, 65325759, 1538055801, 515192888, 483885487,
    157393079, 1695124103, 2005211659, 1540072241, 88064245, 1542985445,
    1269900459, 1461624142, 825701067, 682402162, 1311873874, 1164520853,
    352275361, 18769, 137,
]
ROU_REV = [
    1, 2013265920, 1728404513, 1592366214, 196396260, 1253260071, 72041623,
    1091445674, 145223211, 1446820157, 1030796471, 2010749425, 1827366325,
    1239938613, 246299276, 596347512, 1893145354, 246074437, 1525739923,
    1194341128, 1463599021, 704606912, 95395244, 15672543, 647517488,
    584175179, 137728885, 749463956,
]

MONT_ONE = R % P
MONT_BETA = (BETA * R) % P
MONT_NBETA = (NBETA * R) % P

_U32 = np.uint32
_U64 = np.uint64

# REDC wraps uint64 intermediates on purpose (see the reference).
np.seterr(over="ignore")


# ---------------------------------------------------------------------------
# Host (numpy) ops — uint64 intermediates, Montgomery-form uint32 arrays
# ---------------------------------------------------------------------------

def mul_np(a, b):
    """Montgomery product of uint32 arrays (both in Montgomery form)."""
    a = np.asarray(a, _U64)
    b = np.asarray(b, _U64)
    o64 = a * b
    low = (-o64) & _U64(0xFFFFFFFF)
    red = (_U64(M) * low) & _U64(0xFFFFFFFF)
    o64 = o64 + red * _U64(P)
    ret = (o64 >> _U64(32)).astype(_U64)
    return np.where(ret >= P, ret - _U64(P), ret).astype(_U32)


def add_np(a, b):
    x = np.asarray(a, _U64) + np.asarray(b, _U64)
    return np.where(x >= P, x - _U64(P), x).astype(_U32)


def sub_np(a, b):
    x = np.asarray(a, _U64) + _U64(P) - np.asarray(b, _U64)
    return np.where(x >= P, x - _U64(P), x).astype(_U32)


def neg_np(a):
    a = np.asarray(a, _U32)
    return np.where(a == 0, a, (_U64(P) - a).astype(_U32))


def encode_np(a):
    """Standard form -> Montgomery form."""
    return mul_np(np.asarray(a, _U32), np.full_like(np.asarray(a, _U32), R2))


def decode_np(a):
    """Montgomery form -> standard form."""
    return mul_np(np.asarray(a, _U32), np.ones_like(np.asarray(a, _U32)))


def pow_np(a, e: int):
    a = np.asarray(a, _U32)
    result = np.full_like(a, MONT_ONE)
    while e > 0:
        if e & 1:
            result = mul_np(result, a)
        a = mul_np(a, a)
        e >>= 1
    return result


def inv_np(a):
    """Multiplicative inverse (inv(0) == 0)."""
    return pow_np(a, P - 2)


def ext_mul_np(a, b):
    """F_p4 product of Montgomery uint32 arrays (x^4 = -BETA), in uint64:
    the raw sums carry R^2 and one R^-1 per output restores Montgomery
    form (as ``ext_mul``); canonical words out."""
    a = np.asarray(a, _U64)
    b = np.asarray(b, _U64)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    p, nb = _U64(P), _U64(NBETA)

    def pm(x, y):
        return x * y % p

    c0 = pm(a0, b0) + nb * ((pm(a1, b3) + pm(a2, b2) + pm(a3, b1)) % p)
    c1 = pm(a0, b1) + pm(a1, b0) + nb * ((pm(a2, b3) + pm(a3, b2)) % p)
    c2 = pm(a0, b2) + pm(a1, b1) + pm(a2, b0) + nb * pm(a3, b3)
    c3 = pm(a0, b3) + pm(a1, b2) + pm(a2, b1) + pm(a3, b0)
    out = np.stack([c0 % p, c1 % p, c2 % p, c3 % p], axis=-1)
    return (out * _U64(R_INV) % p).astype(_U32)


def ext_inv_np(a):
    """Inverse in F_p4 by the composite-field method."""
    a = np.asarray(a, _U32)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    beta = encode_np(np.array(BETA, _U32))
    nbeta = encode_np(np.array(NBETA, _U32))
    m, ad, sb = mul_np, add_np, sub_np
    b0 = ad(m(a0, a0), m(beta, sb(m(a1, ad(a3, a3)), m(a2, a2))))
    b2 = ad(sb(m(a0, ad(a2, a2)), m(a1, a1)), m(beta, m(a3, a3)))
    c = ad(m(b0, b0), m(beta, m(b2, b2)))
    ic = inv_np(c)
    b0 = m(b0, ic)
    b2 = m(b2, ic)
    o0 = ad(m(a0, b0), m(beta, m(a2, b2)))
    o1 = ad(m(neg_np(a1), b0), m(nbeta, m(a3, b2)))
    o2 = ad(m(neg_np(a0), b2), m(a2, b0))
    o3 = sb(m(a1, b2), m(a3, b0))
    return np.stack([o0, o1, o2, o3], axis=-1)


def ext_pow_np(a, e: int):
    a = np.asarray(a, _U32)
    result = np.zeros_like(a)
    result[..., 0] = MONT_ONE
    while e > 0:
        if e & 1:
            result = ext_mul_np(result, a)
        a = ext_mul_np(a, a)
        e >>= 1
    return result


def ext_powers_np(x, n: int):
    """(4,) -> (n, 4) powers x^0..x^{n-1} (Montgomery), by doubling."""
    out = np.zeros((max(n, 1), 4), _U32)
    out[0, 0] = MONT_ONE
    cur = np.asarray(x, _U32)
    length = 1
    while length < n:
        k = min(length, n - length)
        out[length : length + k] = ext_mul_np(out[:k], cur[None, :])
        cur = ext_mul_np(cur, cur)
        length *= 2
    return out


# ---------------------------------------------------------------------------
# Host scalar helpers (python ints, Montgomery form)
# ---------------------------------------------------------------------------

def s_mul(a: int, b: int) -> int:
    o64 = a * b
    low = (-o64) & 0xFFFFFFFF
    red = (M * low) & 0xFFFFFFFF
    o64 += red * P
    ret = o64 >> 32
    return ret - P if ret >= P else ret


def s_add(a: int, b: int) -> int:
    x = a + b
    return x - P if x >= P else x


def s_sub(a: int, b: int) -> int:
    x = a - b
    return x + P if x < 0 else x


def s_encode(a: int) -> int:
    return s_mul(a % P, R2)


def s_decode(a: int) -> int:
    return s_mul(a, 1)


def s_pow(a: int, e: int) -> int:
    result = MONT_ONE
    while e > 0:
        if e & 1:
            result = s_mul(result, a)
        a = s_mul(a, a)
        e >>= 1
    return result


def s_inv(a: int) -> int:
    return s_pow(a, P - 2)


# ---------------------------------------------------------------------------
# Device (torch) ops — int32 storage, int64 only where a product needs it
# ---------------------------------------------------------------------------

def add(a, b):
    # a - (P - b) lies in (-P, P): no int32 overflow, one conditional fix
    x = a - (P - b)
    return torch.where(x < 0, x + P, x)


def sub(a, b):
    x = a - b
    return torch.where(x < 0, x + P, x)


def neg(a):
    return torch.where(a == 0, a, P - a)


def _i64(x):
    return x.to(torch.int64) if torch.is_tensor(x) else x


def mul(a, b):
    """Montgomery product a*b*R^-1 mod P, canonical int32.  Either operand
    may be a python int (a Montgomery word)."""
    return (_i64(a) * _i64(b) % P * R_INV % P).to(torch.int32)


def sum_mod(x, dim):
    """Field sum along `dim` of canonical words: one int64 sum, one mod.
    Exact for fewer than 2^32 terms."""
    return (x.to(torch.int64).sum(dim=dim) % P).to(torch.int32)


def encode(a):
    return mul(a, R2)


def decode(a):
    return mul(a, 1)


def pow_static(a, e: int):
    result = torch.full_like(a, MONT_ONE)
    while e > 0:
        if e & 1:
            result = mul(result, a)
        a = mul(a, a)
        e >>= 1
    return result


def inv(a):
    return pow_static(a, P - 2)


def ext_mul(a, b):
    """F_p4 product on (..., 4) int32 tensors (x^4 = -BETA)."""
    a0, a1, a2, a3 = a.to(torch.int64).unbind(-1)
    b0, b1, b2, b3 = b.to(torch.int64).unbind(-1)

    def pm(x, y):
        return x * y % P

    # raw products carry R^2; one R^-1 per output restores Montgomery form
    c0 = pm(a0, b0) + NBETA * ((pm(a1, b3) + pm(a2, b2) + pm(a3, b1)) % P)
    c1 = pm(a0, b1) + pm(a1, b0) + NBETA * ((pm(a2, b3) + pm(a3, b2)) % P)
    c2 = pm(a0, b2) + pm(a1, b1) + pm(a2, b0) + NBETA * pm(a3, b3)
    c3 = pm(a0, b3) + pm(a1, b2) + pm(a2, b1) + pm(a3, b0)
    out = torch.stack([c0 % P, c1 % P, c2 % P, c3 % P], dim=-1)
    return (out * R_INV % P).to(torch.int32)


def ext_inv(a):
    """F_p4 inverse of (..., 4) int32 tensors (composite-field method)."""
    a0, a1, a2, a3 = a.unbind(-1)
    b0 = add(mul(a0, a0), mul(MONT_BETA, sub(mul(a1, add(a3, a3)),
                                            mul(a2, a2))))
    b2 = add(sub(mul(a0, add(a2, a2)), mul(a1, a1)),
             mul(MONT_BETA, mul(a3, a3)))
    ic = inv(add(mul(b0, b0), mul(MONT_BETA, mul(b2, b2))))
    b0 = mul(b0, ic)
    b2 = mul(b2, ic)
    o0 = add(mul(a0, b0), mul(MONT_BETA, mul(a2, b2)))
    o1 = add(mul(neg(a1), b0), mul(MONT_NBETA, mul(a3, b2)))
    o2 = add(mul(neg(a0), b2), mul(a2, b0))
    o3 = sub(mul(a1, b2), mul(a3, b0))
    return torch.stack([o0, o1, o2, o3], dim=-1)


def ext_powers(x, n: int):
    """(..., 4) -> (..., n, 4) powers x^0..x^{n-1} by doubling."""
    powers = torch.zeros(x.shape[:-1] + (1, 4), dtype=torch.int32,
                         device=x.device)
    powers[..., 0, 0] = MONT_ONE
    cur = x
    length = 1
    while length < n:
        nxt = ext_mul(powers, cur.unsqueeze(-2))
        powers = torch.cat([powers, nxt], dim=-2)
        cur = ext_mul(cur, cur)
        length *= 2
    return powers[..., :n, :]
