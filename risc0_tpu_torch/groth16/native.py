"""ctypes bindings for the native BN254 core (csrc/bn254.cpp, built into
``csrc/libr0vm.so`` by ``zkvm/native.py``; counterpart of
``risc0_tpu/groth16/native.py``).

Value conventions match the C side: field elements are (n, 4) uint64
little-endian limb arrays; "mont" = Montgomery form with R = 2^256,
"std" = canonical integers.  G1 affine points are (n, 8) u64
(x, y Montgomery Fq, (0, 0) = infinity); G2 affine are (n, 16) u64
(x.c0, x.c1, y.c0, y.c1).

The reference runs its BN254 proving math inside external libraries
(ark-bn254 / rapidsnark via docker, risc0/groth16/src/prove/docker.rs);
this binding backs the in-process Groth16 setup/prove path.
"""

from __future__ import annotations

import ctypes as Ct
from functools import lru_cache

import numpy as np

from . import bn254 as bn

Q = bn.R        # scalar field (Fr) modulus
P = bn.P        # base field (Fq) modulus
_R256 = 1 << 256

_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def limbs(v: int) -> np.ndarray:
    """int -> (4,) u64 little-endian limbs."""
    return np.array([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)],
                    np.uint64)


def unlimbs(a) -> int:
    a = np.asarray(a, np.uint64).ravel()
    return int(a[0]) | int(a[1]) << 64 | int(a[2]) << 128 | int(a[3]) << 192


def fr_arr(vals, mont: bool = True) -> np.ndarray:
    """list[int] (canonical) -> (n, 4) u64 limb array, Montgomery by default."""
    out = np.empty((len(vals), 4), np.uint64)
    if mont:
        for i, v in enumerate(vals):
            out[i] = limbs(v * _R256 % Q)
    else:
        for i, v in enumerate(vals):
            out[i] = limbs(v % Q)
    return out


def fr_list(arr, mont: bool = True) -> list[int]:
    arr = np.asarray(arr, np.uint64).reshape(-1, 4)
    inv_r = pow(_R256, -1, Q) if mont else 1
    return [unlimbs(row) * inv_r % Q for row in arr]


def g1_arr(points) -> np.ndarray:
    """list[(x, y) | None] affine std ints -> (n, 8) u64 Montgomery."""
    out = np.zeros((len(points), 8), np.uint64)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        x, y = pt
        out[i, :4] = limbs(x * _R256 % P)
        out[i, 4:] = limbs(y * _R256 % P)
    return out


def g1_from_arr(arr):
    arr = np.asarray(arr, np.uint64).reshape(-1, 8)
    inv_r = pow(_R256, -1, P)
    out = []
    for row in arr:
        x = unlimbs(row[:4]) * inv_r % P
        y = unlimbs(row[4:]) * inv_r % P
        out.append(None if x == 0 and y == 0 else (x, y))
    return out


def g2_arr(points) -> np.ndarray:
    """list[((x0,x1),(y0,y1)) | None] -> (n, 16) u64 Montgomery."""
    out = np.zeros((len(points), 16), np.uint64)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        (x0, x1), (y0, y1) = pt
        out[i, 0:4] = limbs(x0 * _R256 % P)
        out[i, 4:8] = limbs(x1 * _R256 % P)
        out[i, 8:12] = limbs(y0 * _R256 % P)
        out[i, 12:16] = limbs(y1 * _R256 % P)
    return out


def g2_from_arr(arr):
    arr = np.asarray(arr, np.uint64).reshape(-1, 16)
    inv_r = pow(_R256, -1, P)
    out = []
    for row in arr:
        vals = [unlimbs(row[4 * i: 4 * i + 4]) * inv_r % P for i in range(4)]
        if all(v == 0 for v in vals):
            out.append(None)
        else:
            out.append(((vals[0], vals[1]), (vals[2], vals[3])))
    return out


@lru_cache(maxsize=1)
def lib():
    from ..zkvm.native import lib as native_lib

    L = native_lib()
    L.bn254_init.argtypes = [_u64p, Ct.c_uint64, _u64p, _u64p,
                             _u64p, Ct.c_uint64, _u64p, _u64p]
    for nm in ("bn254_fr_to_mont", "bn254_fr_from_mont"):
        getattr(L, nm).argtypes = [_u64p, _u64p, Ct.c_uint64]
    for nm in ("bn254_fr_vec_mul", "bn254_fr_vec_sub"):
        getattr(L, nm).argtypes = [_u64p, _u64p, _u64p, Ct.c_uint64]
    L.bn254_fr_vec_scale.argtypes = [_u64p, _u64p, _u64p, Ct.c_uint64]
    L.bn254_fr_powers.argtypes = [_u64p, _u64p, Ct.c_uint64]
    L.bn254_fr_inv.argtypes = [_u64p, _u64p]
    L.bn254_fr_batch_inv.argtypes = [_u64p, Ct.c_uint64]
    L.bn254_fr_ntt.argtypes = [_u64p, Ct.c_uint64, _u64p]
    L.bn254_fr_spmv.argtypes = [_u32p, _u32p, _u64p, Ct.c_uint64, _u64p, _u64p]
    L.bn254_fr_qap.argtypes = [_u32p, _u32p, _u64p, Ct.c_uint64, _u64p, _u64p]
    for nm in ("bn254_g1_msm", "bn254_g2_msm", "bn254_g1_fixed_msm",
               "bn254_g2_fixed_msm"):
        getattr(L, nm).argtypes = [_u64p, _u64p, Ct.c_uint64, _u64p, Ct.c_int]
    for nm in ("bn254_g1_add", "bn254_g2_add", "bn254_g1_mul", "bn254_g2_mul"):
        getattr(L, nm).argtypes = [_u64p, _u64p, _u64p]

    fq_np = (-pow(P, -1, 1 << 64)) % (1 << 64)
    fr_np = (-pow(Q, -1, 1 << 64)) % (1 << 64)
    L.bn254_init(
        limbs(P), fq_np, limbs(_R256 * _R256 % P), limbs(_R256 % P),
        limbs(Q), fr_np, limbs(_R256 * _R256 % Q), limbs(_R256 % Q))
    return L


# --- convenience wrappers -------------------------------------------------

def g1_msm(points_arr: np.ndarray, scalars: list[int], n_threads=0):
    """points (n,8) mont array x canonical int scalars -> affine point."""
    n = points_arr.shape[0]
    sc = fr_arr(scalars, mont=False)
    out = np.zeros(8, np.uint64)
    lib().bn254_g1_msm(np.ascontiguousarray(points_arr), sc, n, out, n_threads)
    return g1_from_arr(out)[0]


def g2_msm(points_arr: np.ndarray, scalars: list[int], n_threads=0):
    n = points_arr.shape[0]
    sc = fr_arr(scalars, mont=False)
    out = np.zeros(16, np.uint64)
    lib().bn254_g2_msm(np.ascontiguousarray(points_arr), sc, n, out, n_threads)
    return g2_from_arr(out)[0]


def g1_fixed_msm(base, scalars: list[int], n_threads=0) -> np.ndarray:
    """base affine (x, y) x canonical scalars -> (n, 8) mont point array."""
    b = g1_arr([base])[0]
    sc = fr_arr(scalars, mont=False)
    out = np.zeros((len(scalars), 8), np.uint64)
    lib().bn254_g1_fixed_msm(b, sc, len(scalars), out, n_threads)
    return out


def g2_fixed_msm(base, scalars: list[int], n_threads=0) -> np.ndarray:
    b = g2_arr([base])[0]
    sc = fr_arr(scalars, mont=False)
    out = np.zeros((len(scalars), 16), np.uint64)
    lib().bn254_g2_fixed_msm(b, sc, len(scalars), out, n_threads)
    return out


def fr_ntt(data: np.ndarray, root: int, inverse: bool = False,
           n: int | None = None) -> np.ndarray:
    """In-place-style NTT over Fr.  data (n,4) Montgomery; root is the
    canonical primitive n-th root for the forward transform."""
    data = np.ascontiguousarray(data, np.uint64)
    n = n or data.shape[0]
    r = pow(root, Q - 2, Q) if inverse else root
    lib().bn254_fr_ntt(data, n, limbs(r * _R256 % Q))
    if inverse:
        n_inv = pow(n, Q - 2, Q)
        lib().bn254_fr_vec_scale(data, limbs(n_inv * _R256 % Q), data, n)
    return data
