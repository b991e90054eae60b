"""Batched NTTs: CUDA kernels and their plain torch versions (counterpart of
``risc0_tpu/hal/pallas/ntt.py``).

``evaluate_ntt`` and ``interpolate_ntt`` are exact drop-ins for
``risc0_tpu_torch.core.ntt``: the plain versions are those functions.  For
a CUDA tensor the wrappers launch the kernels in
``risc0_tpu_torch/csrc/ntt.cu`` or raise.  Each wrapper counts its launches
in ``<wrapper>.launches`` (one per call; a call runs one to three CUDA
kernels).

The kernels make two passes over device memory for n <= 2^24:
``split(n_bits)`` gives (k1, k2), the contiguous pass runs the stages
inside 2^k1-word blocks and the strided pass the next k2 stages, whose
twiddles separate into A_m[q'] * B_m[r] (the Pallas four-step), in tiles
of 2^k2 rows x 2^cols_bits(k2) offsets.  Both blocks hold at most
2^BLOCK_BITS words of shared memory.  Above 2^24 each remaining stage is
one launch.

Twiddles (``host_tables``), built on the host and uploaded once per
(n_bits, direction, device):
  * ``local``: stage l's w_l^j (j < 2^(l-1)) at 2^(l-1) - 1 + j, for
    l = 1..max(k1, k2): the Pallas ``_stage_tables``, and the A halves of
    its ``_outer_tables`` (A_m is the local table of stage m);
  * ``outer``: w_(k1+m)^r (r < 2^k1) at (m-1) * 2^k1 + r, m = 1..k2: the
    B halves of ``_outer_tables``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ... import field as F
from ...core import ntt as ntt_mod
from . import build

_MAX_BATCH = 65535  # grid.y
BLOCK_BITS = 14      # a block's tile: at most 2^14 words (64 KB)
LOCAL_MAX_BITS = 12  # n_bits at or below this: one contiguous pass
COLS_BITS = 5        # strided tile width: 32 offsets, 128-byte row reads


def split(n_bits: int) -> tuple[int, int]:
    """(k1, k2) for a 2^n_bits transform: the contiguous pass runs stages
    1..k1, the strided pass k1+1..k1+k2; k1 + k2 == n_bits up to 2^24.
    k2 stays at most BLOCK_BITS - COLS_BITS while k1 can grow, so the
    tile keeps its 32 offsets; above, the tile narrows to 16."""
    if n_bits <= LOCAL_MAX_BITS:
        return n_bits, 0
    k1 = min(BLOCK_BITS, max(LOCAL_MAX_BITS, n_bits - BLOCK_BITS + COLS_BITS))
    return k1, min(BLOCK_BITS - COLS_BITS + 1, n_bits - k1)


def cols_bits(k2: int) -> int:
    """log2 of the strided tile's width in offsets (16 or 32 words)."""
    return min(COLS_BITS, BLOCK_BITS - k2)


@lru_cache(maxsize=None)
def host_tables(n_bits: int, fwd: bool) -> tuple[np.ndarray, np.ndarray]:
    """(local, outer) twiddle words (Montgomery u32) of a 2^n_bits NTT."""
    k1, k2 = split(n_bits)
    rm = F.s_encode(F.ROU_FWD[n_bits] if fwd else F.ROU_REV[n_bits])

    def stage_root(l):  # w_l = W^(2^(n_bits - l))
        return F.s_pow(rm, 1 << (n_bits - l))

    local = [ntt_mod.pow_table(stage_root(l), 1 << (l - 1))
             for l in range(1, max(k1, k2) + 1)]
    outer = [ntt_mod.pow_table(stage_root(k1 + m), 1 << k1)
             for m in range(1, k2 + 1)]
    one = [np.zeros(1, np.uint32)]  # a table the kernel never reads
    return np.concatenate(local or one), np.concatenate(outer or one)


_DEVICE_TABLES: dict = {}


def _tables(n_bits: int, fwd: bool, device):
    """(local, outer, full) device tensors; full (W^0..W^(n/2-1)) only
    where stages run one launch each (n_bits > 24), else None."""
    key = (n_bits, fwd, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        local, outer = (torch.from_numpy(a.view(np.int32)).to(device)
                        for a in host_tables(n_bits, fwd))
        k1, k2 = split(n_bits)
        full = (ntt_mod.device_table("twiddles", n_bits, device, fwd)
                if k1 + k2 < n_bits else None)
        t = _DEVICE_TABLES[key] = (local, outer, full)
    return t


def evaluate_ntt_plain(x, expand_bits: int = 0):
    return ntt_mod.evaluate_ntt(x, expand_bits)


def interpolate_ntt_plain(x):
    return ntt_mod.interpolate_ntt(x)


def _prepare(x, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (batch, n) int32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    batch, n = x.shape
    if batch > _MAX_BATCH:
        raise ValueError(f"{what}: batch {batch} > {_MAX_BATCH}")
    return batch, ntt_mod.log2_ceil(n)


def _launch(fn, what, x, n_bits, fwd, last):
    batch = x.shape[0]
    if x.data_ptr() % 16:  # the kernels read 16-byte vectors
        x = x.clone()
    out = torch.empty_like(x)
    local, outer, full = _tables(n_bits, fwd, x.device)
    k1, k2 = split(n_bits)
    build.check(fn(
        x.data_ptr(), out.data_ptr(), local.data_ptr(), outer.data_ptr(),
        0 if full is None else full.data_ptr(), batch, n_bits, k1, k2,
        cols_bits(k2), last, torch.cuda.current_stream(x.device).cuda_stream),
        what)
    return out


def evaluate_ntt(x, expand_bits: int = 0):
    """(batch, n) bit-reversed coeffs -> natural evaluations, skipping the
    bottom `expand_bits` stages."""
    if x.device.type == "cpu":
        return evaluate_ntt_plain(x, expand_bits)
    _, n_bits = _prepare(x, "evaluate_ntt")
    out = _launch(build.library().ntt_evaluate, "ntt_evaluate", x, n_bits,
                  True, expand_bits)
    evaluate_ntt.launches += 1
    return out


evaluate_ntt.launches = 0


def interpolate_ntt(x):
    """(batch, n) natural evaluations -> bit-reversed coeffs times 1/n."""
    if x.device.type == "cpu":
        return interpolate_ntt_plain(x)
    _, n_bits = _prepare(x, "interpolate_ntt")
    norm = F.s_inv(F.s_encode((1 << n_bits) % F.P))
    out = _launch(build.library().ntt_interpolate, "ntt_interpolate", x,
                  n_bits, False, norm)
    interpolate_ntt.launches += 1
    return out


interpolate_ntt.launches = 0
