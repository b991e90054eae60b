# The port's own copy of risc0_tpu/perf.py, with torch device sync.
"""Hierarchical scope timers (reference: risc0/core/src/perf.rs:41-74).

A `scope(name)` is a span of the process tracer (`telemetry.tracer()`):
nested scopes form dotted paths (a.b.c), and the tracer totals (calls,
seconds) per path.  `report()` returns that table and `reset()` clears
it; neither touches the spans.  Enabled by default (RISC0_TPU_PERF=0
turns the tracer off, and a scope then costs one branch).

CUDA work is asynchronous: a scope that only enqueues kernels measures
the enqueue.  Pass `sync=` a torch tensor or device and, when that device
is CUDA, the scope ends with `torch.cuda.synchronize(device)`, so it
covers the device work it started.  `sync=` on a CPU device is a no-op.
"""

from __future__ import annotations

import torch

from . import telemetry


class _Scope:
    __slots__ = ("name", "sync", "handle")

    def __init__(self, name: str, sync):
        self.name = name
        self.sync = sync

    def __enter__(self):
        self.handle = telemetry.tracer().scope(self.name)
        return self

    def __exit__(self, et, ev, tb):
        sync = self.sync
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) \
                else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self.handle.__exit__(et, ev, tb)


def scope(name: str, sync=None):
    """Time a region; nested scopes form dotted paths (a.b.c)."""
    if not telemetry.ENABLED:
        return telemetry.NO_SPAN
    return _Scope(name, sync)


def report() -> dict[str, tuple[int, float]]:
    """{dotted path: (calls, total seconds)} snapshot."""
    return telemetry.tracer().totals()


def reset():
    telemetry.tracer().reset_totals()


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
