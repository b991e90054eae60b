# The port's own copy of risc0_tpu/log.py.
"""Structured JSON-lines logging (SURVEY §5 metrics/logging; the
reference r0vm cluster emits tracing + OTel telemetry — here a
dependency-free equivalent).

Set RISC0_TPU_LOG to a file path (append) or "stderr" to enable; unset
means no-op.  Every record is one JSON object per line with a wall-clock
timestamp, an event name, and the caller's fields:

    {"ts": 1766001234.56, "event": "task_done", "kind": "lift", ...}

The scheduler logs task lifecycle, the provers log session proofs, and
perf scopes can be flushed with `flush_perf()`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

_lock = threading.Lock()
_sink = None
_checked = False


def _get_sink():
    global _sink, _checked
    if not _checked:
        _checked = True
        target = os.environ.get("RISC0_TPU_LOG")
        if target == "stderr":
            _sink = sys.stderr
        elif target:
            _sink = open(target, "a")
    return _sink


def reset() -> None:
    """Re-read RISC0_TPU_LOG (tests)."""
    global _sink, _checked
    with _lock:
        if _sink is not None and _sink is not sys.stderr:
            _sink.close()
        _sink = None
        _checked = False


def enabled() -> bool:
    return _get_sink() is not None


def event(name: str, **fields) -> None:
    sink = _get_sink()
    if sink is None:
        return
    rec = {"ts": round(time.time(), 6), "event": name}
    rec.update(fields)
    line = json.dumps(rec, default=str)
    with _lock:
        sink.write(line + "\n")
        sink.flush()


def flush_perf(min_ms: float = 1.0, device=None) -> None:
    """Emit one record per perf scope accumulated so far and, for a CUDA
    `device`, one of its allocator's current and peak bytes."""
    if not enabled():
        return
    import torch

    from . import perf

    for name, (count, total_s) in perf.report().items():
        if total_s * 1e3 >= min_ms:
            event("perf_scope", scope=name,
                  total_ms=round(total_s * 1e3, 2), count=count)
    if device is not None and torch.device(device).type == "cuda":
        mem = perf.device_memory(device)
        if mem is not None:
            event("device_memory", device=str(device), **mem)
