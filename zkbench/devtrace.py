"""The device trace of one traced item, and the host's scope log beside it.

The card is traced with torch.profiler's CUDA activity alone (kernels,
copies and sets), read from kineto's raw events: building the Python event
tree of `prof.events()` takes minutes over the accum witgen's launches.
Host and device clocks are tied by a marker kernel launched right after a
synchronisation at the start of the item.  Host scopes (the program's perf
scopes and the harness's call timers) are logged on the host clock, so an
idle gap of the card can be named after the innermost scope open on the
host during it.
"""

import time
from contextlib import contextmanager

MARKER_CYCLES = 1000


def _start_ns(e):
    return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000


def _duration_ns(e):
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else e.duration_us() * 1000)


class ScopeLog:
    """(name, host start, host end) of every scope closed while logging."""

    def __init__(self):
        self.spans = []

    @contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def innermost(self, t):
        best = None
        for name, t0, t1 in self.spans:
            if t0 <= t <= t1 and (best is None or t1 - t0 < best[1]):
                best = (name, t1 - t0)
        return best[0] if best else "(no scope)"


@contextmanager
def logging_perf_scopes(perf, log: ScopeLog):
    """Route every `perf.scope` of the program through `log` as well."""
    orig = perf.scope

    @contextmanager
    def scope(name, sync=None):
        with log.span(name), orig(name, sync=sync):
            yield

    perf.scope = scope
    try:
        yield
    finally:
        perf.scope = orig


class DeviceTrace:
    """Device operations of a traced region: [(name, start ns, end ns)] on
    the profiler's clock, and the host time its marker was launched."""

    def __init__(self, ops, host_t0, marker_ns, host_s):
        self.ops = ops
        self.host_t0 = host_t0
        self.marker_ns = marker_ns
        self.window_s = host_s

    def host_time(self, ns):
        return self.host_t0 + (ns - self.marker_ns) / 1e9

    def busy_intervals(self):
        end_ns = self.marker_ns + self.window_s * 1e9
        merged = []
        for _n, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.marker_ns), min(e, end_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """[(start ns, end ns)] in which no operation ran on the card."""
        gaps, cur = [], self.marker_ns
        for s, e in self.busy_intervals():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        end_ns = self.marker_ns + self.window_s * 1e9
        if end_ns > cur:
            gaps.append((cur, end_ns))
        return gaps

    def seconds_by_name(self, match=None):
        """{name: device seconds}, of the operations whose name contains
        one of `match` (all when None)."""
        out = {}
        for n, s, e in self.ops:
            if match is None or any(m in n for m in match):
                out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out


def trace_call(fn):
    """Run fn() under the profiler's CUDA activity; returns (result,
    DeviceTrace).  Requires a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        host_t0 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host_t0
    ops = []
    marker_ns = None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = _start_ns(e)
        if "spin_kernel" in e.name() and (marker_ns is None or s < marker_ns):
            marker_ns = s
        ops.append((e.name(), s, s + _duration_ns(e)))
    if not ops:
        raise RuntimeError("the profiler recorded no device activity")
    if marker_ns is None:  # no marker by that name: the first operation
        marker_ns = min(s for _n, s, _e in ops)
    return out, DeviceTrace(ops, host_t0, marker_ns, host_s)


def short_name(name: str) -> str:
    """A kernel's name without its parameter list, at most 160 letters."""
    if name.endswith(")") and "(" in name:
        name = name[:name.rfind("(")]
    return name[:160]


def breakdown(trace: DeviceTrace, scopes: ScopeLog, top: int = 10):
    """{"device_ops": [[name, s]], "idle_gaps": [[host scope, s]]}: the
    device operations that took most time, and the idle time of the card
    summed by the innermost host scope open at each gap's middle."""
    by_name = {}
    for n, v in trace.seconds_by_name().items():
        by_name[short_name(n)] = by_name.get(short_name(n), 0.0) + v
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = {}
    for s, e in trace.idle_gaps():
        label = scopes.innermost(trace.host_time((s + e) / 2))
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, v] for n, v in ops[:top]],
            "idle_gaps": [[n, v] for n, v in gaps[:top]]}
