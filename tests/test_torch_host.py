"""The port's host layer against the JAX package: the DevModeProver (the
claim digest of every operation), ProverOpts and RISC0_DEV_MODE,
get_prover_server, ProverImpl's compress and lift_povw(work=) on stubs,
serde, the multi_test methods guest, bigint2, the execution trace, the
gdb stub, and the log and telemetry records (tests/test_zkvm_host.py,
test_scheduler.py, test_methods.py, test_bigint.py, test_gdb.py,
test_log.py and test_telemetry.py are the JAX package's own).

The same inputs go through both packages and the outputs must be equal.
Two differences are deliberate (ROADMAP.md queue 3): the dev-mode union
binds the Assumption digests under the allowed root, as the union program
proves, where the JAX fake union binds the bare claim digests; and the
multi_test guest's verify branch commits its assumption, so the ELF
equals the JAX ELF only with that fold left out.
"""

import importlib
import json

import numpy as np
import pytest

PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
LOOP = "guests/loop.bin"
MULTI_SEGMENT_COUNT = 1024 * 494 + 818  # 30 segments at po2 16


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def loop_elf():
    with open(LOOP, "rb") as f:
        return f.read()


def _session(pkg, elf, count, job=None):
    E = _mod(pkg, "zkvm.exec")
    kw = {}
    if job is not None:
        kw["povw_job_id"] = _mod(pkg, "zkvm.povw").PovwJobId(*job)
    env = E.ExecutorEnv(segment_po2=16, **kw).write_slice(
        count.to_bytes(4, "little"))
    return E.ExecutorImpl(env, elf).run()


def _claim(pkg, tag, exit_kind="SystemSplit", assumptions=()):
    """A ReceiptClaim of fixed words: pre/post states from `tag`, and with
    `assumptions` ((claim words, root words), ...) an Output carrying them."""
    C = _mod(pkg, "zkvm.claims")
    output = None
    if exit_kind == "Halted":
        items = [C.MaybePruned.of(C.Assumption(np.asarray(c, np.uint32),
                                               np.asarray(r, np.uint32)))
                 for c, r in assumptions]
        output = C.MaybePruned.of(C.Output(
            C.MaybePruned.from_digest(np.full(8, 77, np.uint32)),
            C.MaybePruned.of(C.Assumptions(items))))
    return C.ReceiptClaim(
        pre=C.MaybePruned.of(C.SystemState(
            0, np.arange(8, dtype=np.uint32) + tag)),
        post=C.MaybePruned.of(C.SystemState(
            4, np.arange(8, dtype=np.uint32) + tag + 1)),
        exit_code=C.ExitCode(exit_kind, 0),
        input=C.MaybePruned.from_digest(np.full(8, 5, np.uint32)),
        output=output)


def _dev(pkg):
    return _mod(pkg, "zkvm.prover").DevModeProver()


def _fake(pkg, claim):
    return _mod(pkg, "zkvm.receipt").FakeReceipt(claim)


def _digest(receipt):
    return np.asarray(receipt.claim.digest(), np.uint32).tobytes().hex()


# -- the DevModeProver --------------------------------------------------------

@pytest.mark.parametrize("count,job", [(10, None),
                                       (MULTI_SEGMENT_COUNT, None),
                                       (MULTI_SEGMENT_COUNT, (0xABC, 3))])
def test_dev_prove_session_claim_and_work_equal_jax(loop_elf, count, job):
    def run(pkg):
        info = _dev(pkg).prove_session(_session(pkg, loop_elf, count, job))
        work = info.work
        return (info.receipt.inner.kind, info.receipt.claim().digest()
                .tobytes().hex(), bytes(info.receipt.journal),
                None if work is None else (work.nonce_min.to_u256(),
                                           work.nonce_max.to_u256(),
                                           work.value))
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "fake"
    assert (got["torch"][3] is None) == (job is None)


def test_dev_prove_session_claim_is_session_claim(loop_elf):
    session = _session("torch", loop_elf, MULTI_SEGMENT_COUNT)
    info = _dev("torch").prove_session(session)
    R = _mod("torch", "zkvm.receipt")
    assert np.array_equal(info.receipt.claim().digest(),
                          R.session_claim(session).digest())
    assert len(session.segments) == 30


def test_dev_lift_join_resolve_keccak_equal_jax():
    roots = [np.full(8, 9, np.uint32), np.zeros(8, np.uint32)]
    a_claims = [np.arange(8, dtype=np.uint32) * 3 + 1,
                np.arange(8, dtype=np.uint32) * 5 + 2]

    def run(pkg):
        P = _dev(pkg)
        left = P.lift(P.prove_segment(None, _claim(pkg, 1)))
        right = P.lift(P.prove_segment_core(
            P.segment_preflight(None), None,
            _claim(pkg, 2, "Halted", zip(a_claims, roots))))
        joined = P.join(left, right)
        once = P.resolve(joined, _fake(pkg, _claim(pkg, 3)))
        twice = P.resolve(once, _fake(pkg, _claim(pkg, 4)))
        keccak = P.prove_keccak({"claim_digest": a_claims[0].tobytes(),
                                 "po2": 14, "control_root": b"\0" * 32,
                                 "input": []})
        return [_digest(r) for r in (left, right, joined, once, twice,
                                     keccak, P.compress(twice),
                                     P.identity_p254(twice),
                                     P.shrink_wrap(twice))]
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][5] == a_claims[0].tobytes().hex()


def test_dev_povw_four_equal_jax():
    def run(pkg):
        P, W = _dev(pkg), _mod(pkg, "zkvm.povw")
        job = W.PovwJobId(log=0x5EED, job=7)
        works = [W.Work(job.nonce(i), job.nonce(i), 1 << (16 - i))
                 for i in range(2)]
        lifted = [P.lift_povw(P.prove_segment(None, _claim(pkg, 10 + i)),
                              work=w) for i, w in enumerate(works)]
        last = _claim(pkg, 11, "Halted",
                      [(np.full(8, 3, np.uint32), np.zeros(8, np.uint32))])
        lifted[1] = P.lift_povw(_fake(pkg, last), work=works[1])
        joined = P.join_povw(lifted[0], lifted[1])
        joined_unwrapped = P.join_povw(lifted[0], lifted[1], unwrap=True)
        unwrapped = P.unwrap_povw(joined)
        resolved = P.resolve_povw(joined, _fake(pkg, _claim(pkg, 30)))
        resolved_unwrapped = P.resolve_povw(
            joined, _fake(pkg, _claim(pkg, 30)), unwrap=True)
        work = joined.claim.work
        return ([_digest(r) for r in (*lifted, joined, joined_unwrapped,
                                      unwrapped, resolved,
                                      resolved_unwrapped)],
                (work.nonce_min.to_u256(), work.nonce_max.to_u256(),
                 work.value))
    got = _both(run)
    assert got["torch"] == got["jax"]
    digests, (lo, hi, value) = got["torch"]
    assert digests[3] == digests[4] and digests[6] != digests[5]
    assert hi == lo + 1 and value == (1 << 16) + (1 << 15)


def test_dev_union_binds_assumptions_under_the_allowed_root():
    """The port's fake union proves what its union program proves; the JAX
    fake union binds the bare claim digests, so one union of two claims
    already differs (ROADMAP.md queue 3; the JAX side is wrong)."""
    R = _mod("torch", "zkvm.receipt")
    C = _mod("torch", "zkvm.claims")
    pred = _mod("torch", "circuit.recursion.predicates")
    _ids, root = pred.own_control_ids()
    a, b = (np.arange(8, dtype=np.uint32) + 50,
            np.arange(8, dtype=np.uint32) + 20)

    def run(pkg):
        M = _mod(pkg, "zkvm.claims")
        P = _dev(pkg)
        ra, rb = (_fake(pkg, M.MaybePruned.from_digest(d)) for d in (a, b))
        return P.union(ra, rb), P.union(rb, ra)
    got = _both(run)
    want = R.union_claim(C.Assumption(a, root).digest(),
                         C.Assumption(b, root).digest())
    for u in got["torch"]:
        assert isinstance(u.claim, C.UnionClaim)
        assert np.array_equal(u.claim.digest(), want.digest())
    jax_union = got["jax"][0].claim
    assert np.array_equal(jax_union.left, b)  # the bare digests, ordered
    assert _digest(got["jax"][0]) != _digest(got["torch"][0])
    # the keccak root of two batches is the port's union of their claims
    K = _mod("torch", "circuit.keccak")
    inputs = [[[1] * 25], [[2] * 25]]
    claims = [K.compute_keccak_digest(x) for x in inputs]
    P = _dev("torch")
    merged = P.union(*(P.prove_keccak({"claim_digest": c.tobytes()})
                       for c in claims))
    assert np.array_equal(
        merged.claim.digest(),
        R.keccak_root_claim([{"input": x} for x in inputs]))


def test_dev_delay_sleeps(monkeypatch):
    Pm = _mod("torch", "zkvm.prover")
    slept = []
    monkeypatch.setattr(Pm.time, "sleep", slept.append)
    P = Pm.DevModeProver(Pm.DevModeDelay(lift=0.25, join=0.5))
    r = P.lift(_fake("torch", _claim("torch", 1)))
    P.join(r, r)
    assert slept == [0.25, 0.5]


# -- options and prover selection ---------------------------------------------

def test_prover_opts_and_dev_mode_env(monkeypatch):
    monkeypatch.delenv("RISC0_DEV_MODE", raising=False)
    got = _both(lambda pkg: _mod(pkg, "zkvm.prover").ProverOpts())
    for field in ("hashfn", "receipt_kind", "max_segment_po2", "dev_mode",
                  "snark_prover", "snark_threads"):
        assert getattr(got["torch"], field) == getattr(got["jax"], field)
    Pm = _mod("torch", "zkvm.prover")
    assert isinstance(Pm.get_prover_server(device="cpu"), Pm.ProverImpl)
    for value, dev in (("1", True), ("true", True), ("0", False),
                       ("", False)):
        monkeypatch.setenv("RISC0_DEV_MODE", value)
        assert Pm.ProverOpts().dev_mode is dev
        server = Pm.get_prover_server(device="cpu")
        assert isinstance(server, Pm.DevModeProver) is dev
    assert isinstance(Pm.get_prover_server(Pm.ProverOpts(dev_mode=True)),
                      Pm.DevModeProver)
    with pytest.raises(ValueError, match="poseidon2 only"):
        Pm.ProverImpl(Pm.ProverOpts(hashfn="sha-256"), device="cpu")


def test_prover_impl_compress_and_lift_povw_work(monkeypatch):
    """compress on a stubbed compress_composite: a composite receipt
    becomes the verified succinct one, a succinct one stays; lift_povw
    checks the Work the scheduler expects against the seal's."""
    Pm = _mod("torch", "zkvm.prover")
    R = _mod("torch", "zkvm.receipt")
    W = _mod("torch", "zkvm.povw")
    drv = _mod("torch", "zkvm.recursion_driver")
    checked = []

    class Stub:
        claim = _claim("torch", 1)

        def verify_integrity(self, ctx):
            checked.append(ctx.control_root is not None and not ctx.dev_mode)

    monkeypatch.setattr(drv, "compress_composite", lambda comp, dev: Stub())
    prover = Pm.ProverImpl(device="cpu")
    composite = R.Receipt(R.InnerReceipt("composite", R.CompositeReceipt(
        segments=[])), b"j")
    out = prover.compress(composite)
    assert out.inner.kind == "succinct" and out.journal == b"j"
    assert checked == [True]
    assert prover.compress(out) is out
    with pytest.raises(ValueError, match="fake"):
        prover.compress(R.Receipt(R.InnerReceipt("fake", None), b""))

    job = W.PovwJobId(1, 2)
    work = W.Work(job.nonce(0), job.nonce(0), 1 << 14)
    monkeypatch.setattr(drv, "lift_povw", lambda sr, dev: R.FakeReceipt(
        W.WorkClaim(sr.claim, work)))
    sr = R.FakeReceipt(_claim("torch", 1))
    assert prover.lift_povw(sr, work=W.Work(job.nonce(0), job.nonce(0),
                                            1 << 14)).claim.work == work
    assert prover.lift_povw(sr).claim.work == work
    with pytest.raises(R.VerificationError, match="work"):
        prover.lift_povw(sr, work=W.Work(job.nonce(1), job.nonce(1),
                                         1 << 14))


def test_prover_impl_refuses_a_segment_above_max_segment_po2(monkeypatch):
    Pm = _mod("torch", "zkvm.prover")
    rv = _mod("torch", "circuit.rv32im.prove")
    monkeypatch.setattr(rv, "segment_preflight",
                        lambda seg, device: ("preflight", seg.po2))
    seg = type("Seg", (), {"po2": 16})()
    prover = Pm.ProverImpl(Pm.ProverOpts(max_segment_po2=16), device="cpu")
    assert prover.segment_preflight(seg) == ("preflight", 16)
    prover = Pm.ProverImpl(Pm.ProverOpts(max_segment_po2=15), device="cpu")
    with pytest.raises(ValueError, match="max_segment_po2 15"):
        prover.segment_preflight(seg)
    with pytest.raises(ValueError, match="max_segment_po2 15"):
        prover.prove_segment(seg, None)


# -- serde, methods, bigint2 ---------------------------------------------------

SERDE_VALUES = [0, 7, 0xFFFFFFFF, -5, 1 << 40, True, 1.5, "héllo", b"\x01\x02",
                [1, 2, 3], ("ab", [b"x", b""], 9), None, [[], ["q"]]]
SERDE_SHAPES = [int, int, int, int, "u64", bool, float, str, bytes, [int],
                (str, [bytes], int), int, [[str]]]


def test_serde_bytes_equal_jax():
    got = _both(lambda pkg: [(_mod(pkg, "zkvm.serde").to_vec(v),
                              _mod(pkg, "zkvm.serde").to_bytes(v))
                             for v in SERDE_VALUES])
    assert got["torch"] == got["jax"]
    S = _mod("torch", "zkvm.serde")
    for v, shape in zip(SERDE_VALUES, SERDE_SHAPES):
        back = S.from_slice(S.to_vec(v), shape)
        assert back == _mod("jax", "zkvm.serde").from_slice(S.to_vec(v),
                                                             shape)
    with pytest.raises(ValueError):
        S.to_vec(1 << 70)


def test_methods_elf_and_image_id_equal_jax_but_the_assumption_digest(
        monkeypatch):
    TM, JM = _mod("torch", "zkvm.methods"), _mod("jax", "zkvm.methods")
    TE, JE = _mod("torch", "zkvm.exec"), _mod("jax", "zkvm.exec")
    repaired = TM.multi_test_elf()
    assert repaired != JM.multi_test_elf()
    monkeypatch.setattr(_mod("torch", "zkvm.guest_env").GuestEnv,
                        "_record_assumption", lambda self, tok: None)
    elf = TM.multi_test_elf()
    assert elf == JM.multi_test_elf()
    assert np.array_equal(
        TE.ExecutorImpl(TE.ExecutorEnv(), elf).compute_image_id(),
        JE.ExecutorImpl(JE.ExecutorEnv(), elf).compute_image_id())
    monkeypatch.undo()

    def run(pkg, spec, *words, raw=b""):
        M, E = _mod(pkg, "zkvm.methods"), _mod(pkg, "zkvm.exec")
        env = E.ExecutorEnv(segment_po2=16).write_slice(
            M.encode_input(spec, *words, raw=raw))
        s = E.ExecutorImpl(env, M.multi_test_elf()).run()
        return s.exit_code, bytes(s.journal), s.user_cycles
    for args in ((TM.BUSY_LOOP, 300), (TM.ECHO,), (TM.SYS_CYCLE_COUNT,),
                 (TM.PAUSE,)):
        raw = bytes(range(32)) if args[0] == TM.ECHO else b""
        got = _both(lambda pkg: run(pkg, *args, raw=raw))
        assert got["torch"][:2] == got["jax"][:2]
    assert TM.encode_input(3, 1, 2) == JM.encode_input(3, 1, 2)


def test_bigint2_programs_and_modmul_equal_jax():
    TB, JB = _mod("torch", "zkvm.bigint2"), _mod("jax", "zkvm.bigint2")
    names = TB.program_names()
    assert names == JB.program_names() and "field/modmul_256" in names
    for name in names:
        assert np.array_equal(TB.program(name), JB.program(name))
    m25519 = (1 << 255) - 19
    a, b = 3 ** 100 % m25519, 7 ** 90 % m25519
    assert TB.modmul(a, b, m25519) == JB.modmul(a, b, m25519) \
        == a * b % m25519
    p384 = (1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1
    assert TB.modmul(a, b, p384, width=384) == a * b % p384


# -- trace and gdb ------------------------------------------------------------

def test_trace_events_equal_jax(loop_elf):
    def run(pkg):
        T = _mod(pkg, "zkvm.trace")
        out = []
        for ev in T.trace_execution(loop_elf, (3).to_bytes(4, "little"),
                                    max_insns=4000):
            out.append((type(ev).__name__, tuple(vars(ev).values())))
        return out
    got = _both(run)
    assert got["torch"] == got["jax"]
    kinds = {k for k, _ in got["torch"]}
    assert kinds == {"InstructionStart", "RegisterSet"}


def test_gdb_stub_replies_equal_jax(loop_elf):
    loop_pc = 0x000100C8  # the loop body (tests/test_gdb.py)
    packets = ["qSupported", "?", "g", "p20", "s", "s", "p20",
               f"Z0,{loop_pc:x},4", "c", "p20", f"m{loop_pc:x},4", "g",
               f"z0,{loop_pc:x},4", "c", "qAttached", "Hg0", "vMustReply"]

    def run(pkg):
        stub = _mod(pkg, "zkvm.gdb").GdbStub(loop_elf,
                                             input=(40).to_bytes(4, "little"))
        try:
            return [stub.handle(p) for p in packets]
        finally:
            stub.machine.close()
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][9] == loop_pc.to_bytes(4, "little").hex()
    assert got["torch"][13] == "W00"


# -- log and telemetry ---------------------------------------------------------

def test_log_records_equal_jax(tmp_path, monkeypatch):
    perf = _mod("torch", "perf")

    def run(pkg):
        L = _mod(pkg, "log")
        path = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("RISC0_TPU_LOG", str(path))
        L.reset()
        try:
            L.event("task_done", kind="lift", job=3, seconds=0.5)
            L.event("obj", value=np.uint32(7))
            assert L.enabled()
        finally:
            monkeypatch.delenv("RISC0_TPU_LOG")
            L.reset()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        for r in recs:
            assert isinstance(r.pop("ts"), float)
        return recs
    got = _both(run)
    assert got["torch"] == got["jax"]

    L = _mod("torch", "log")
    path = tmp_path / "perf.jsonl"
    monkeypatch.setenv("RISC0_TPU_LOG", str(path))
    L.reset()
    try:
        perf.reset()
        with perf.scope("stage"):
            sum(range(200000))
        L.flush_perf(min_ms=0.0, device="cpu")
    finally:
        monkeypatch.delenv("RISC0_TPU_LOG")
        L.reset()
        perf.reset()
    (rec,) = [json.loads(x) for x in path.read_text().splitlines()]
    assert rec["event"] == "perf_scope" and rec["scope"] == "stage"
    assert rec["count"] == 1


def test_telemetry_spans_and_metrics_equal_jax():
    def run(pkg):
        T = _mod(pkg, "telemetry")
        tracer, metrics = T.Tracer(service="svc"), T.Metrics()
        with tracer.span("job", job=1):
            ctx = tracer.ctx()
            with tracer.span("child", n=2, f=0.5, ok=True):
                pass
        with pytest.raises(RuntimeError):
            with tracer.span("task", parent=ctx, worker="w"):
                raise RuntimeError("boom")
        metrics.inc("risc0_tasks_submitted", kind="lift")
        metrics.inc("risc0_tasks_submitted", 2, kind="lift")
        for s in (0.0005, 0.2, 7.0, 5000.0):
            metrics.observe("risc0_task_run_seconds", s, kind="join")
        spans = tracer.finished()
        shape = [(s.name, s.parent_id == (spans[1].span_id
                                          if s.name == "child" else
                                          ctx[1] if s.name == "task"
                                          else None),
                  s.status, s.attributes) for s in spans]
        otlp = [{k: v for k, v in s.to_otlp().items()
                 if k not in ("traceId", "spanId", "parentSpanId",
                              "startTimeUnixNano", "endTimeUnixNano")}
                for s in spans]
        return shape, otlp, metrics.snapshot(), metrics.expose()
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert [s[0] for s in got["torch"][0]] == ["child", "job", "task"]
    assert got["torch"][0][2][2] == "ERROR"
