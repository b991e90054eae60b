"""Exchange of field words between numpy (uint32, as the reference and the
host code keep them) and torch (int32 on a given device, as the port keeps
them).  Canonical words are below P < 2^31, so the bit pattern is the same
in both types and the conversion is a reinterpretation."""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy u32 (or anything np.asarray takes) -> a new int32 tensor on
    device (never a view of the caller's array)."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device, copy=True)


def to_numpy(t) -> np.ndarray:
    """int32 tensor (any device) -> numpy u32."""
    if isinstance(t, np.ndarray):
        return np.asarray(t, np.uint32)
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
