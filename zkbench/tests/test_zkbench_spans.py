"""The readers of the program's spans (zkbench/spans.py and the metrics
that use it), on fake spans and a fake device trace."""

import pytest

from risc0_tpu_torch.telemetry import Span
from zkbench import manifest, spans
from zkbench.devtrace import DeviceTrace
from zkbench.tests.test_zkbench_discovery import ROOT

S = 10**9  # ns a second
T0 = 100.0  # host seconds at the trace's marker


def read(name, readings):
    return manifest.Cell(ROOT, "loop20.segment").metric_reader(name).read(
        readings)


class Spans:
    """Spans on one host clock; a span with a parent joins its trace."""

    def __init__(self):
        self.out = []
        self.n = 0

    def add(self, name, start_s, end_s, parent=None):
        self.n += 1
        s = Span(name=name, span_id=f"s{self.n}",
                 trace_id=parent.trace_id if parent else f"t{self.n}",
                 parent_id=parent.span_id if parent else None,
                 start_ns=int(start_s * S), end_ns=int(end_s * S))
        self.out.append(s)
        return s


@pytest.fixture
def fake(monkeypatch):
    sp = Spans()
    monkeypatch.setattr(spans, "recorded", lambda: sp.out)
    return sp


def segment_run(sp, eval_s=(4.0, 6.0), traced=(T0 + 1, T0 + 9)):
    """A set-up root, two window items and a traced one, each a
    prove_segment root over an eval_check span 2-3 s into it."""
    sp.add("execute", 1.0, 2.0)
    for i, e in enumerate(eval_s):
        r = sp.add("prove_segment", 10.0 * (i + 1), 10.0 * (i + 1) + 9)
        sp.add("eval_check", r.start_ns / S + 2, r.start_ns / S + 2 + e, r)
    r = sp.add("prove_segment", T0 + 5e-5, T0 + 12)  # just after the marker
    sp.add("eval_check", *traced, r)
    return {"items": [{}, {}], "config": {}}


def trace(ops, window_s=20.0):
    """A DeviceTrace whose marker ran at host second T0."""
    return DeviceTrace([(n, int(s * S), int(e * S)) for n, s, e in ops],
                       T0, 0, window_s)


def test_launches_inside_a_span(fake):
    readings = segment_run(fake)
    readings["trace"] = trace([
        ("spin_kernel", 0.0, 0.001),
        ("k_before", 0.5, 0.6),              # in the root, before eval
        ("k_in", 1.0, 1.5),                  # starts on the span's start
        ("Memcpy HtoD (Pageable -> Device)", 2.0, 2.1),
        ("Memset (Device)", 2.2, 2.3),
        ("k_in", 3.0, 4.0),
        ("k_late", 9.5, 9.6),                # after eval, in the root
        ("k_out", 12.5, 12.6)])              # after the root
    assert read("eval_check_launches", readings) == 2
    assert read("prove_launches", readings) == 4


def test_launches_snap_to_the_idle_card_at_a_span_end(fake):
    """The trace's clock runs 0.4 ms early here: the start of the next
    scope's burst, launched after eval_check's synchronisation, reads as
    inside it, but the card's widest idle gap near the end is the one
    the synchronisation left."""
    readings = segment_run(fake)  # traced eval_check: host T0+1 .. T0+9
    ops = [("k_in", 1.0 + i * 1e-3, 1.0 + i * 1e-3 + 5e-4) for i in range(4)]
    ops += [("k_in", 8.9964 + i * 1e-5, 8.9964 + i * 1e-5 + 8e-6)
            for i in range(300)]         # eval's last burst, to 8.9994
    ops += [("k_next", 8.9996 + i * 1e-5, 8.9996 + i * 1e-5 + 9e-6)
            for i in range(300)]         # the next scope's, 8.9996-9.0026
    readings["trace"] = trace(ops)
    assert sum(1 for n, s, _e in readings["trace"].ops
               if n == "k_next" and s < 9 * S) == 40
    assert read("eval_check_launches", readings) == 304


def test_idle_inside_a_span_over_the_unprofiled_mean(fake):
    readings = segment_run(fake)  # window eval_check spans 4 and 6 s
    readings["trace"] = trace([("k", 0.0, 1.5),   # 0.5 s inside
                               ("k", 2.0, 3.0),   # 1 s
                               ("k", 2.5, 4.0),   # overlaps: 1 s more
                               ("k", 8.5, 10.0)])  # 0.5 s inside
    assert read("eval_check_idle_pct", readings) == pytest.approx(
        100 * (1 - 3.0 / 5.0))


def test_no_trace_no_device_reading(fake):
    readings = segment_run(fake)
    readings["trace"] = None
    for name in ("eval_check_launches", "eval_check_idle_pct",
                 "prove_launches"):
        assert read(name, readings) is None


def receipt_item(sp, t):
    """A prove root at host second t and its layers."""
    r = sp.add("prove", t, t + 20)
    sp.add("execute", t + 0.5, t + 1.5, r)
    sp.add("prove_segment", t + 2, t + 8, r)
    lift = sp.add("lift", t + 8.5, t + 15, r)
    sp.add("rec_preflight", t + 9, t + 13, lift)
    check = sp.add("self_check", t + 15, t + 19, r)
    sp.add("verify_validity", t + 15.5, t + 16, check)
    sp.add("verify_fri", t + 16, t + 18.5, check)
    sp.add("verify_validity", t + 9.5, t + 10, lift)  # not the self-check
    return r


def test_span_twins_and_self_time(fake):
    for t in (10, 40, 70):  # the window's two items, then the traced one
        receipt_item(fake, t)
    readings = {"items": [{}, {}], "trace": None}
    want = {"execute_span_s": 1.0, "prove_segment_span_s": 6.0,
            "rec_prove_span_s": 6.5 - 4.0, "self_check_span_s": 4.0,
            "self_check_validity_s": 0.5, "self_check_fri_s": 2.5,
            "receipt_self_s": 20 - (1 + 6 + 6.5 + 4)}
    for name, v in want.items():
        assert read(name, readings) == pytest.approx(v), name


def test_self_time_counts_overlapping_children_once(fake):
    r = fake.add("prove", 0, 10)
    fake.add("a", 1, 4, r)
    fake.add("b", 3, 5, r)   # overlaps a by 1 s
    fake.add("c", 9, 12, r)  # ends after the root
    got = spans.items({"items": []})
    assert got[1].root is r
    assert got[1].self_s() == pytest.approx(10 - 4 - 1)


def test_mean_over_window_items_only(fake):
    receipt_item(fake, 10)
    second = receipt_item(fake, 40)
    fake.out = [s for s in fake.out if not (s.name == "execute"
                                            and s.parent_id ==
                                            second.span_id)]
    receipt_item(fake, 70)
    readings = {"items": [{}, {}], "trace": None}
    assert read("execute_span_s", readings) == pytest.approx(1.0)


SEGMENT = ("eval_check_launches", "eval_check_idle_pct", "prove_launches")
BARE = {"receipt_self_s": 1.0, "prove_launches": 1}  # read from roots alone


@pytest.mark.parametrize("name", [
    "execute_span_s", "prove_segment_span_s", "rec_prove_span_s",
    "self_check_span_s", "self_check_validity_s", "self_check_fri_s",
    "receipt_self_s", *SEGMENT])
def test_none_when_spans_are_missing(fake, name):
    readings = {"items": [{}, {}], "trace": trace([("k", 0.5, 0.6)])}
    assert read(name, readings) is None   # no spans at all
    root = "prove_segment" if name in SEGMENT else "prove"
    for t in (T0 - 20, T0 - 10):
        fake.add(root, t, t + 1)
    assert read(name, readings) is None   # one root short of the items
    fake.add(root, T0, T0 + 1)            # roots without layer spans
    assert read(name, readings) == BARE.get(name)
