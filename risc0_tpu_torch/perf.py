# The port's own copy of risc0_tpu/perf.py, with torch device sync.
"""Hierarchical scope timers (reference: risc0/core/src/perf.rs:41-74).

A `scope(name)` context manager accumulates (calls, seconds) per dotted
path into a process-global registry.  Enabled by default (the overhead is
two clock reads per scope); `report()` returns the table, `reset()` clears
it, and `summary()` formats it for logs.

CUDA work is asynchronous: a scope that only enqueues kernels measures
the enqueue.  Pass `sync=` a torch tensor or device and, when that device
is CUDA, the scope ends with `torch.cuda.synchronize(device)`, so it
covers the device work it started.  `sync=` on a CPU device is a no-op.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

import torch

_lock = threading.Lock()
_stats: dict[str, list[float]] = {}   # path -> [calls, seconds]
_tls = threading.local()

ENABLED = os.environ.get("RISC0_TPU_PERF", "1") != "0"


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def _sync_device(sync) -> torch.device:
    if isinstance(sync, torch.Tensor):
        return sync.device
    return torch.device(sync)


@contextmanager
def scope(name: str, sync=None):
    """Time a region; nested scopes form dotted paths (a.b.c)."""
    if not ENABLED:
        yield
        return
    st = _stack()
    st.append(name)
    path = ".".join(st)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            dev = _sync_device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        st.pop()
        with _lock:
            ent = _stats.setdefault(path, [0, 0.0])
            ent[0] += 1
            ent[1] += dt


def report() -> dict[str, tuple[int, float]]:
    """{dotted path: (calls, total seconds)} snapshot."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _stats.items()}


def reset():
    with _lock:
        _stats.clear()


def toplevel_seconds() -> float:
    """Sum of depth-0 scope time: set against an externally timed total,
    it exposes unscoped host time."""
    return sum(secs for path, (_c, secs) in report().items()
               if "." not in path)


def device_memory(device=None) -> dict | None:
    """Current/peak allocator bytes of a CUDA device (the HAL
    MemoryTracker equivalent, reference zkp/src/hal/mod.rs:292-317), from
    `torch.cuda.memory_stats`; None where there is no CUDA device."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    keep = {"bytes_in_use": "allocated_bytes.all.current",
            "peak_bytes_in_use": "allocated_bytes.all.peak"}
    out = {k: int(stats[v]) for k, v in keep.items() if v in stats}
    return out or None


def summary(min_ms: float = 0.1) -> str:
    rows = sorted(report().items(), key=lambda kv: -kv[1][1])
    lines = []
    for path, (calls, secs) in rows:
        if secs * 1e3 < min_ms:
            continue
        lines.append(f"{secs * 1e3:10.1f} ms  x{calls:<5d} {path}")
    return "\n".join(lines)
