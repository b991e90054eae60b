"""Batched BabyBear NTT in plain torch (counterpart of ``risc0_tpu/core/ntt.py``).

Coefficient arrays are stored **bit-reversed**, evaluation arrays in
natural order:

  * ``evaluate_ntt(x, expand_bits)``: DIT butterflies from bit-reversed
    coeffs to natural evaluations, skipping the bottom ``expand_bits``
    stages (inputs made by ``expand`` are constant inside those blocks);
  * ``interpolate_ntt(x)``: DIF butterflies from natural evaluations to
    bit-reversed coefficients, scaled by 1/n.

These are the plain versions of the CUDA NTT kernels
(``risc0_tpu_torch/hal/cuda/ntt.py``), which the prover calls.  The numpy
mirrors serve the host verifier and the tests.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import field as F


def log2_ceil(n: int) -> int:
    b = (n - 1).bit_length()
    if not (1 << b == n or n == 1):
        raise ValueError(f"not a power of two: {n}")
    return b if n > 1 else 0


@lru_cache(maxsize=None)
def _bitrev_perm(n_bits: int) -> np.ndarray:
    n = 1 << n_bits
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, np.int32)
    for b in range(n_bits):
        rev |= (((idx >> b) & 1) << (n_bits - 1 - b)).astype(np.int32)
    return rev


def pow_table(base_mont: int, count: int) -> np.ndarray:
    """base^0..base^(count-1) (Montgomery) by doubling: the same words as
    the reference's sequential loop, since field products are exact."""
    out = np.empty(max(count, 1), np.uint32)
    out[0] = F.MONT_ONE
    length, step = 1, base_mont
    while length < count:
        k = min(length, count - length)
        out[length : length + k] = F.mul_np(out[:k], np.uint32(step))
        step = F.s_mul(step, step)
        length *= 2
    return out[:count]


@lru_cache(maxsize=None)
def _twiddles(n_bits: int, fwd: bool) -> np.ndarray:
    """Powers w^0..w^(n/2-1) of the (inverse) 2^n_bits-th root, Montgomery."""
    root = F.ROU_FWD[n_bits] if fwd else F.ROU_REV[n_bits]
    return pow_table(F.s_encode(root), 1 << (n_bits - 1))


@lru_cache(maxsize=None)
def _zk_shift_table(n_bits: int) -> np.ndarray:
    """3^rev(pos) for each bit-reversed position."""
    return pow_table(F.s_encode(3), 1 << n_bits)[_bitrev_perm(n_bits)]


_DEVICE_TABLES: dict = {}


def device_table(name: str, n_bits: int, device, fwd: bool = True):
    """A host table ('twiddles', 'zk_shift', 'bitrev') uploaded once per
    (n_bits, direction, device) and kept as int32 (bitrev as int64)."""
    key = (name, n_bits, fwd, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        if name == "twiddles":
            t = torch.from_numpy(_twiddles(n_bits, fwd).view(np.int32))
        elif name == "zk_shift":
            t = torch.from_numpy(_zk_shift_table(n_bits).view(np.int32))
        elif name == "bitrev":
            t = torch.from_numpy(_bitrev_perm(n_bits).astype(np.int64))
        else:
            raise KeyError(name)
        t = t.to(device)
        _DEVICE_TABLES[key] = t
    return t


def evaluate_ntt(x, expand_bits: int = 0):
    """(batch..., n) bit-reversed coeffs -> natural evaluations."""
    n = x.shape[-1]
    n_bits = log2_ceil(n)
    if n_bits == 0:
        return x.clone()
    tw_full = device_table("twiddles", n_bits, x.device, True)
    for l in range(expand_bits + 1, n_bits + 1):
        half = 1 << (l - 1)
        tw = tw_full[:: 1 << (n_bits - l)]  # ROU_FWD[l]^i
        y = x.reshape(x.shape[:-1] + (n >> l, 2, half))
        a = y[..., 0, :]
        b = F.mul(y[..., 1, :], tw)
        x = torch.stack([F.add(a, b), F.sub(a, b)], dim=-2).reshape(x.shape)
    return x


def interpolate_ntt(x):
    """(batch..., n) natural evaluations -> bit-reversed coeffs (scaled 1/n)."""
    n = x.shape[-1]
    n_bits = log2_ceil(n)
    if n_bits == 0:
        return x.clone()
    tw_full = device_table("twiddles", n_bits, x.device, False)
    for l in range(n_bits, 0, -1):
        half = 1 << (l - 1)
        tw = tw_full[:: 1 << (n_bits - l)]  # ROU_REV[l]^i
        y = x.reshape(x.shape[:-1] + (n >> l, 2, half))
        a = y[..., 0, :]
        b = y[..., 1, :]
        x = torch.stack([F.add(a, b), F.mul(F.sub(a, b), tw)],
                        dim=-2).reshape(x.shape)
    return F.mul(x, F.s_inv(F.s_encode(n % F.P)))


def bit_reverse(x):
    """Apply the bit-reversal permutation along the last axis."""
    n_bits = log2_ceil(x.shape[-1])
    return x.index_select(-1, device_table("bitrev", n_bits, x.device))


def expand(x, expand_bits: int):
    """Repeat each element 2^expand_bits times (reference ntt.rs:334-347)."""
    return torch.repeat_interleave(x, 1 << expand_bits, dim=-1)


def zk_shift(x):
    """f(x) -> f(3x) on bit-reversed coeffs (multiply coeff i by 3^i)."""
    n_bits = log2_ceil(x.shape[-1])
    return F.mul(x, device_table("zk_shift", n_bits, x.device))


# Host (numpy) mirrors ----------------------------------------------------------

def interpolate_ntt_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    n = x.shape[-1]
    n_bits = log2_ceil(n)
    for l in range(n_bits, 0, -1):
        half = 1 << (l - 1)
        tw = _twiddles(n_bits, fwd=False)[:: 1 << (n_bits - l)]
        y = x.reshape(x.shape[:-1] + (n >> l, 2, half))
        a, b = y[..., 0, :], y[..., 1, :]
        y = np.stack([F.add_np(a, b), F.mul_np(F.sub_np(a, b), tw)], axis=-2)
        x = y.reshape(x.shape)
    norm = F.s_inv(F.s_encode(n % F.P))
    return F.mul_np(x, np.full(x.shape, norm, np.uint32))


def evaluate_ntt_np(x: np.ndarray, expand_bits: int = 0) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    n = x.shape[-1]
    n_bits = log2_ceil(n)
    for l in range(expand_bits + 1, n_bits + 1):
        half = 1 << (l - 1)
        tw = _twiddles(n_bits, fwd=True)[:: 1 << (n_bits - l)]
        y = x.reshape(x.shape[:-1] + (n >> l, 2, half))
        a = y[..., 0, :]
        b = F.mul_np(y[..., 1, :], tw)
        y = np.stack([F.add_np(a, b), F.sub_np(a, b)], axis=-2)
        x = y.reshape(x.shape)
    return x
