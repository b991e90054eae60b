"""The port's one recorder: perf scopes and layer boundaries are spans of
`telemetry.tracer()`, one trace per request, on time.perf_counter_ns.

The segment prove here is the po2 6 fib prove of test_torch_prove.py put
in place of the rv32im core (the rv32im prove of the smallest segment,
po2 14, takes a minute on the CPU): it runs the same generic prover, so
the same perf scopes, under the rv32im and ProverImpl entry points and
the real executor.  The self-check verifies that fib seal with the host
verifier.
"""

import os
import time

import pytest
import torch

from risc0_tpu_torch import perf, telemetry
from risc0_tpu_torch.circuit import fib
from risc0_tpu_torch.circuit.rv32im import prove as rv
from risc0_tpu_torch.parallel import scheduler as S
from risc0_tpu_torch.zkvm import prover as Pm
from risc0_tpu_torch.zkvm import receipt as R
from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# perf.report() of one segment prove, as the parent commit keys it: the
# exec witgen's scope, then the generic prover's
PROVER_KEYS = [
    "check_commit", "combos", "combos.combos_divide", "combos.combos_mix",
    "combos.combos_prepare", "combos.combos_sum", "commit_group.0",
    "commit_group.1", "commit_group.2", "eval_check", "fri_prove",
    "fri_prove.inner_prefetch", "fri_prove.query_write",
    "fri_prove.round_prefetch", "fri_prove.rounds", "soundness", "tap_eval",
    "tap_eval.tap_check_eval", "tap_eval.tap_commit", "tap_eval.tap_device",
    "tap_eval.tap_interp", "tap_eval.tap_xs"]
SEGMENT_KEYS = sorted(["witgen_exec"] + PROVER_KEYS)


def _elf():
    with open(os.path.join(REPO, "guests", "loop.bin"), "rb") as f:
        return f.read()


def _env(count=100):
    return ExecutorEnv(segment_po2=16).write_slice(count.to_bytes(4,
                                                                  "little"))


@pytest.fixture
def fib_core(monkeypatch):
    """The rv32im segment prover with the fib prove as its core."""
    monkeypatch.setattr(rv, "witgen_exec",
                        lambda seg, rand_z: {"rows": 1 << seg.po2})
    monkeypatch.setattr(rv, "prove_segment_core",
                        lambda res, device, **kw: fib.prove(
                            po2=6, seed=0, device=device))


def _since(t0):
    return [s for s in telemetry.tracer().finished() if s.start_ns >= t0]


def _one_request(spans, t0, t1):
    """The root of spans that make one request, checked: one root, one
    trace, every parent present, times inside [t0, t1], each scope under
    the scope its dotted path names or, at the top of a path, under a
    boundary span."""
    by_id = {s.span_id: s for s in spans}
    (root,) = [s for s in spans if s.parent_id is None]
    assert {s.trace_id for s in spans} == {root.trace_id}
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s.name
        assert s.thread == root.thread
        if s is root:
            continue
        parent = by_id[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        if s.path is not None:
            assert s.path == (s.name if parent.path is None
                              else parent.path + "." + s.name), s.path
    return root


def _children(spans, parent, scopes=False):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent_id == parent.span_id
            and (s.path is not None) == scopes]


def test_prove_segment_is_one_request(fib_core):
    seg = ExecutorImpl(_env(), _elf()).run().segments[0]
    perf.reset()
    t0 = time.perf_counter_ns()
    rv.prove_segment(seg, rand_z=(1, 2, 3, 4), device="cpu")
    t1 = time.perf_counter_ns()
    spans = _since(t0)
    root = _one_request(spans, t0, t1)
    assert (root.name, root.attributes) == ("prove_segment", {"po2": 14})
    assert _children(spans, root) == []
    assert _children(spans, root, scopes=True) == [
        "witgen_exec", "commit_group.1", "commit_group.2", "commit_group.0",
        "eval_check", "check_commit", "tap_eval", "combos", "fri_prove",
        "soundness"]
    assert sorted(perf.report()) == SEGMENT_KEYS
    assert sorted({s.path for s in spans if s.path}) == SEGMENT_KEYS


def test_prover_impl_prove_is_one_request(fib_core, monkeypatch):
    monkeypatch.setattr(R.SegmentReceipt, "verify_integrity",
                        lambda self, ctx: fib.verify(self.seal, device="cpu"))
    prover = Pm.ProverImpl(Pm.ProverOpts(receipt_kind="composite"),
                           device="cpu")
    perf.reset()
    t0 = time.perf_counter_ns()
    info = prover.prove(_env(), _elf())
    t1 = time.perf_counter_ns()
    assert info.receipt.inner.kind == "composite"
    spans = _since(t0)
    root = _one_request(spans, t0, t1)
    assert root.name == "prove"
    assert _children(spans, root) == ["execute", "prove_segment",
                                      "self_check"]
    assert _children(spans, root, scopes=True) == []
    kids = {s.name: s for s in spans if s.parent_id == root.span_id}
    assert kids["execute"].attributes == {"segments": 1}
    assert kids["prove_segment"].attributes == {"po2": 14}
    assert _children(spans, kids["prove_segment"]) == []  # not nested
    assert _children(spans, kids["self_check"]) == ["verify_validity",
                                                     "verify_fri"]
    assert sorted(perf.report()) == SEGMENT_KEYS


def test_perf_off_records_nothing(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: syncs.append(dev))
    card = torch.device("cuda")
    t0 = time.perf_counter_ns()
    with perf.scope("scope_on", sync=card):
        pass
    assert len(syncs) == 1 and [s.name for s in _since(t0)] == ["scope_on"]

    monkeypatch.setattr(telemetry, "ENABLED", False)
    perf.reset()
    t0 = time.perf_counter_ns()
    with perf.scope("scope_off", sync=card):
        with telemetry.tracer().span("span_off") as sp:
            sp.set(n=1)
    info = Pm.DevModeProver().prove(_env(10), _elf())
    assert info.session.segments
    assert _since(t0) == [] and perf.report() == {}
    assert len(syncs) == 1


def test_reset_keeps_open_and_finished_spans():
    t0 = time.perf_counter_ns()
    with telemetry.boundary("request"):
        with perf.scope("before"):
            pass
        perf.reset()
        with perf.scope("after"):
            pass
    assert sorted(perf.report()) == ["after"]
    root, = [s for s in _since(t0) if s.name == "request"]
    assert sorted(s.name for s in _since(t0)
                  if s.parent_id == root.span_id) == ["after", "before"]
    # OTLP takes Unix nanoseconds, from the monotonic stamps
    otlp = root.to_otlp()
    assert abs(int(otlp["startTimeUnixNano"]) - time.time_ns()) < 60e9
    assert int(otlp["endTimeUnixNano"]) - int(otlp["startTimeUnixNano"]) \
        == root.end_ns - root.start_ns


def test_scheduler_task_parents_the_prove_spans():
    class Spanning(Pm.DevModeProver):
        prove_segment = Pm.ProverImpl.prove_segment

    prover = Spanning()
    factory = S.Factory()
    workers = S.make_local_pools(factory, prover, num_cpu=1, num_accel=1)
    t0 = time.perf_counter_ns()
    try:
        S.ProofJob(factory, prover, _env(10), _elf(),
                   receipt_kind="composite").run()
    finally:
        for w in workers:
            w.stop()
    spans = _since(t0)
    by_id = {s.span_id: s for s in spans}
    (job,) = [s for s in spans if s.name == "proof_job"]
    assert {s.trace_id for s in spans} == {job.trace_id}
    for name, task in (("execute", "task:execute"),
                       ("prove_segment", "task:prove_segment")):
        hit = [s for s in spans if s.name == name]
        assert hit
        for s in hit:
            parent = by_id[s.parent_id]
            assert parent.name == task
            assert parent.parent_id == job.span_id
            assert parent.thread == s.thread != job.thread


def test_threads_record_their_own_requests():
    """Workers' requests stay apart and the totals lose no scope."""
    import sys
    import threading

    perf.reset()
    t0 = time.perf_counter_ns()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(50):
                with telemetry.boundary("request"):
                    with perf.scope("outer"):
                        with perf.scope("inner"):
                            pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert {k: v[0] for k, v in perf.report().items()} == {
        "outer": 800, "outer.inner": 800}
    spans = _since(t0)
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.parent_id is None]
    assert len(roots) == 800 and len(spans) == 2400
    for s in spans:
        if s.parent_id is not None:
            parent = by_id[s.parent_id]
            assert (parent.thread, parent.trace_id) == (s.thread, s.trace_id)
