"""The program's own spans of the run's items, read from its recorder
(`risc0_tpu_torch.telemetry`), alone or beside the device trace.

Every item is one request of the program, so one root span: the last
root is the traced item, and the `len(readings["items"])` roots of its
name before it are the window's items, which ran unprofiled.  Spans are
on `time.perf_counter_ns()`, the host clock the device trace is tied to.
A program that records no such roots gives no reading: every reader then
returns None.
"""

COPIES = ("Memcpy", "Memset")


def recorded():
    """The recorder's finished spans."""
    from risc0_tpu_torch import telemetry

    return telemetry.tracer().finished()


class Item:
    """One item's spans: its root and the tree of the root's trace."""

    def __init__(self, root, spans):
        self.root = root
        self.kids = {}
        for s in spans:
            if s.trace_id == root.trace_id and s.parent_id is not None:
                self.kids.setdefault(s.parent_id, []).append(s)

    def under(self, span, name):
        """The spans of that name below `span`."""
        out, todo = [], list(self.kids.get(span.span_id, ()))
        while todo:
            s = todo.pop()
            if s.name == name:
                out.append(s)
            todo.extend(self.kids.get(s.span_id, ()))
        return out

    def seconds(self, name, inside=None, minus=None):
        """Seconds of the spans `name` (below the spans `inside`, when
        given), each less its spans `minus`; None if there is none."""
        tops = [self.root] if inside is None else \
            self.under(self.root, inside)
        hit = [s for t in tops for s in self.under(t, name)]
        if not hit:
            return None
        return sum(duration_s(s) - sum(duration_s(m)
                                       for m in self.under(s, minus))
                   if minus else duration_s(s) for s in hit)

    def self_s(self):
        """The root's self time: its duration less what its children
        cover."""
        r = self.root
        cover, end = 0, r.start_ns
        for s in sorted(self.kids.get(r.span_id, ()),
                        key=lambda s: s.start_ns):
            lo, hi = max(s.start_ns, end), min(s.end_ns, r.end_ns)
            if hi > lo:
                cover += hi - lo
                end = hi
        return (r.end_ns - r.start_ns - cover) / 1e9


def duration_s(span):
    return (span.end_ns - span.start_ns) / 1e9


def items(readings):
    """(the window's items, the traced item) as Items; None unless the
    recorder holds a root for each."""
    spans = recorded()
    roots = sorted((s for s in spans if s.parent_id is None),
                   key=lambda s: s.start_ns)
    if not roots:
        return None
    roots = [s for s in roots if s.name == roots[-1].name]
    n = len(readings["items"])
    if len(roots) < n + 1:
        return None
    out = [Item(r, spans) for r in roots[-n - 1:]]
    return out[:-1], out[-1]


def mean_item_s(readings, read):
    """Mean over the window's items of read(item), those that read None
    left out; None if every item does."""
    got = items(readings)
    if got is None:
        return None
    values = [v for v in (read(it) for it in got[0]) if v is not None]
    return sum(values) / len(values) if values else None


def traced_span(readings, name):
    """The traced item's first span `name`; None without one or without
    a device trace."""
    got = items(readings)
    if got is None or readings.get("trace") is None:
        return None
    hit = sorted(got[1].under(got[1].root, name), key=lambda s: s.start_ns)
    return hit[0] if hit else None


# how far a span's end may be moved to the card's idle gap: the device
# trace's host times drift 0.5-0.7 ms from the host clock over a traced
# po2 20 prove (NVIDIA H100 80GB HBM3 at 700 W)
SNAP_NS = 2_000_000


def device_bounds(trace, span):
    """The span's ends on the card's clock (ns), each moved into the widest
    idle gap of the card within SNAP_NS of it.  A span that ends in a
    synchronisation, with bursts of launches on both sides (eval_check,
    check_commit), has the card idle across its ends for longer than
    between the launches of a burst; the drift of the trace's clock would
    otherwise put a kernel or two on the wrong side."""
    gaps = trace.idle_gaps()

    def snap(ns):
        t = trace.marker_ns + (ns / 1e9 - trace.host_t0) * 1e9
        near = [g for g in gaps if g[1] > t - SNAP_NS and g[0] < t + SNAP_NS]
        if not near:  # inside a long kernel
            return t
        g0, g1 = max(near, key=lambda g: g[1] - g[0])
        return min(max(t, g0), g1)

    return snap(span.start_ns), snap(span.end_ns)


def launches_in(trace, span):
    """Kernels (not copies or sets) that start inside the span."""
    lo, hi = device_bounds(trace, span)
    return sum(1 for n, s, _e in trace.ops
               if not n.startswith(COPIES) and lo <= s < hi)


def busy_in_s(trace, span):
    """Seconds the card was busy inside the span."""
    lo, hi = device_bounds(trace, span)
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in trace.busy_intervals()) / 1e9
