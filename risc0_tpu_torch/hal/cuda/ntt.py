"""Batched NTTs: CUDA kernels and their plain torch versions (counterpart of
``risc0_tpu/hal/pallas/ntt.py``).

``evaluate_ntt`` and ``interpolate_ntt`` are exact drop-ins for
``risc0_tpu_torch.core.ntt``: the plain versions are those functions.  For
a CUDA tensor the wrappers launch the kernels in
``risc0_tpu_torch/csrc/ntt.cu`` (any size, including sizes at or below
the kernel's local block) or raise.  Each wrapper counts its launches in
``<wrapper>.launches`` (one per call; a call runs one or more CUDA
kernels).

Twiddles: one table W^0..W^(n/2-1) per (n_bits, direction), built on the
host (``core.ntt._twiddles``) and uploaded once per device; stage l reads
it at stride 2^(n_bits-l).  These are the same words as the Pallas
``_stage_tables`` and ``_outer_tables``, since field products are exact.
"""

from __future__ import annotations

import torch

from ... import field as F
from ...core import ntt as ntt_mod
from . import build

_MAX_BATCH = 65535  # grid.y of the local pass


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


def _table(n_bits: int, fwd: bool, device) -> int:
    if n_bits == 0:
        return 0  # no stages: the kernel reads no twiddle
    return ntt_mod.device_table("twiddles", n_bits, device, fwd).data_ptr()


def evaluate_ntt(x, expand_bits: int = 0):
    """(batch, n) bit-reversed coeffs -> natural evaluations, skipping the
    bottom `expand_bits` stages."""
    if x.device.type == "cpu":
        return evaluate_ntt_plain(x, expand_bits)
    batch, n_bits = _prepare(x, "evaluate_ntt")
    lib = build.library()
    out = torch.empty_like(x)
    build.check(lib.ntt_evaluate(
        x.data_ptr(), out.data_ptr(), _table(n_bits, True, x.device), batch,
        n_bits, expand_bits, torch.cuda.current_stream(x.device).cuda_stream),
        "ntt_evaluate")
    evaluate_ntt.launches += 1
    return out


evaluate_ntt.launches = 0


def interpolate_ntt(x):
    """(batch, n) natural evaluations -> bit-reversed coeffs times 1/n."""
    if x.device.type == "cpu":
        return interpolate_ntt_plain(x)
    batch, n_bits = _prepare(x, "interpolate_ntt")
    lib = build.library()
    out = torch.empty_like(x)
    norm = F.s_inv(F.s_encode((1 << n_bits) % F.P))
    build.check(lib.ntt_interpolate(
        x.data_ptr(), out.data_ptr(), _table(n_bits, False, x.device), batch,
        n_bits, norm, torch.cuda.current_stream(x.device).cuda_stream),
        "ntt_interpolate")
    interpolate_ntt.launches += 1
    return out


interpolate_ntt.launches = 0
