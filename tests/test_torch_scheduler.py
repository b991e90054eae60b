"""The port's proof-job scheduler and cluster config against the JAX
package's, both on the DevModeProver (tests/test_scheduler.py,
test_cluster_config.py, test_remote_scheduler.py and test_assets.py are
the JAX package's own): the final claim digests and Work of ProofJob for
one and many segments, split preflight, PoVW, the resolve chain, the
composite kind and retries; the union tree over coprocessor receipts; the
TOML config, a remote worker and the asset server over localhost; and
the first use of the kernel library and the witgen graphs from several
threads.

The union tree is the deliberate difference (ROADMAP.md queue 3): the
port's fake union binds Assumption digests under the allowed root, as the
union program proves, and the port's ProofJob merges in the order the
guest assumed; so with two or more batches the port's job resolves the
guest's keccak assumption and the JAX job leaves it assumed.
"""

import importlib
import sys
import threading
import time

import numpy as np
import pytest

PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
LOOP = "guests/loop.bin"
MANY = 1024 * 494 + 818  # 30 segments at po2 16


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def loop_elf():
    with open(LOOP, "rb") as f:
        return f.read()


def _env(pkg, count, **kw):
    if "povw_job_id" in kw:
        kw["povw_job_id"] = _mod(pkg, "zkvm.povw").PovwJobId(
            *kw["povw_job_id"])
    return _mod(pkg, "zkvm.exec").ExecutorEnv(segment_po2=16, **kw) \
        .write_slice(count.to_bytes(4, "little"))


def _run(pkg, env, elf, prover=None, num_cpu=1, num_accel=2, **job_kw):
    """(session, receipt, job) of one ProofJob over local pools."""
    S = _mod(pkg, "parallel.scheduler")
    prover = prover or _mod(pkg, "zkvm.prover").DevModeProver()
    factory = S.Factory()
    workers = S.make_local_pools(factory, prover, num_cpu=num_cpu,
                                 num_accel=num_accel)
    try:
        job = S.ProofJob(factory, prover, env, elf, **job_kw)
        session, receipt = job.run()
        return session, receipt, job
    finally:
        for w in workers:
            w.stop()


def _hex(d):
    return np.asarray(d, np.uint32).tobytes().hex()


def _work(w):
    return None if w is None else (w.nonce_min.to_u256(),
                                   w.nonce_max.to_u256(), w.value)


# -- ProofJob against the JAX package's ------------------------------------------

@pytest.mark.parametrize("count,kw", [
    (10, {}), (MANY, {}), (MANY, {"split_preflight": True}),
    (MANY, {"receipt_kind": "composite"}),
    (MANY, {"povw_job_id": (0xDEADBEEF, 42)}),
    (10, {"povw_job_id": (0xDEADBEEF, 43), "split_preflight": True})],
    ids=["single", "multi", "split", "composite", "povw", "povw-single"])
def test_job_claim_and_work_equal_jax(loop_elf, count, kw):
    env_kw = {k: v for k, v in kw.items() if k == "povw_job_id"}
    job_kw = {k: v for k, v in kw.items() if k != "povw_job_id"}

    def run(pkg):
        session, receipt, job = _run(pkg, _env(pkg, count, **env_kw),
                                     loop_elf, **job_kw)
        claim = receipt.claim() if callable(receipt.claim) else receipt.claim
        return (len(session.segments), _hex(claim.digest()), _work(job.work),
                type(receipt).__name__)
    got = _both(run)
    assert got["torch"] == got["jax"]
    n, digest, work, _kind = got["torch"]
    session = _mod("torch", "zkvm.exec").ExecutorImpl(
        _env("torch", count, **env_kw), loop_elf).run()
    assert digest == _hex(_mod("torch", "zkvm.receipt")
                          .session_claim(session).digest())
    assert n == (1 if count == 10 else 30)
    assert (work is None) == ("povw_job_id" not in kw)
    if work is not None:
        assert work[2] == sum(1 << s.po2 for s in session.segments)


def test_composite_job_chains_segment_receipts(loop_elf):
    class NoLift(_mod("torch", "zkvm.prover").DevModeProver):
        def lift(self, *a, **k):
            raise AssertionError("lift must not run in composite mode")

        join = lift_povw = lift

    session, receipt, _job = _run("torch", _env("torch", MANY), loop_elf,
                                  NoLift(), receipt_kind="composite")
    assert len(receipt.segments) == len(session.segments) == 30
    for a, b in zip(receipt.segments, receipt.segments[1:]):
        assert np.array_equal(a.claim.post.digest(), b.claim.pre.digest())


def test_groth16_kind_shrink_wraps(loop_elf):
    wrapped = []

    class WrapSpy(_mod("torch", "zkvm.prover").DevModeProver):
        def shrink_wrap(self, receipt):
            wrapped.append(receipt)
            return ("p254", receipt)

    _s, receipt, _job = _run("torch", _env("torch", 100_000), loop_elf,
                             WrapSpy(), receipt_kind="groth16")
    assert receipt[0] == "p254" and len(wrapped) == 1
    assert receipt[1].claim.exit_code.kind == "Halted"


def _claim_stub(pkg, i):
    C = _mod(pkg, "zkvm.claims")
    state = C.SystemState(0, np.full(8, i + 1, np.uint32))
    return C.ReceiptClaim(pre=C.MaybePruned.of(state),
                          post=C.MaybePruned.of(state),
                          exit_code=C.ExitCode("Halted", 0))


def test_resolve_chain_equal_jax(loop_elf):
    """Session assumptions feed RESOLVE tasks after the join tree; each
    strips the head assumption (the JAX test's custom processors)."""
    def run(pkg):
        S = _mod(pkg, "parallel.scheduler")
        C = _mod(pkg, "zkvm.claims")
        E = _mod(pkg, "zkvm.exec")
        R = _mod(pkg, "zkvm.receipt")
        prover = _mod(pkg, "zkvm.prover").DevModeProver()
        assum = [R.FakeReceipt(_claim_stub(pkg, i)) for i in (7, 9)]

        def assumption(r):
            return C.Assumption(np.asarray(r.claim.digest(), np.uint32),
                                np.zeros(8, np.uint32))

        def cpu(task):
            session = E.ExecutorImpl(*task.payload).run()
            session.assumptions_used = [(assumption(r), r) for r in assum]
            return session

        def accel(task):
            if task.kind == S.TaskKind.PROVE_SEGMENT:
                seg, claim = task.payload
                claim.output = C.MaybePruned.of(C.Output(
                    C.MaybePruned.from_digest(np.zeros(8, np.uint32)),
                    C.MaybePruned.of(C.Assumptions(
                        [C.MaybePruned.of(assumption(r)) for r in assum]))))
                return prover.prove_segment(seg, claim)
            if task.kind == S.TaskKind.LIFT:
                return prover.lift(task.payload[1])
            if task.kind == S.TaskKind.RESOLVE:
                return prover.resolve(*task.payload[:2])
            raise RuntimeError(task.kind)

        factory = S.Factory()
        workers = [
            S.Worker(factory, [S.TaskKind.EXECUTE], cpu, "cpu").start(),
            S.Worker(factory, [S.TaskKind.PROVE_SEGMENT, S.TaskKind.LIFT,
                               S.TaskKind.RESOLVE], accel, "accel").start()]
        try:
            _s, receipt = S.ProofJob(factory, prover, _env(pkg, 10),
                                     loop_elf).run()
        finally:
            for w in workers:
                w.stop()
        return (_hex(receipt.claim.digest()),
                len(receipt.claim.output.value.assumptions.value.items))
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 0


def test_retries_then_the_failure_surfaces(loop_elf):
    """A task that fails is resubmitted up to max_retries; a persistent
    failure raises the worker's own error from the job: nothing proves it
    another way."""
    Pm = _mod("torch", "zkvm.prover")
    calls = {"n": 0}

    class Flaky(Pm.DevModeProver):
        fail = 1

        def prove_segment(self, seg, claim):
            calls["n"] += 1
            if calls["n"] <= self.fail:
                raise RuntimeError("transient fault")
            return super().prove_segment(seg, claim)

    _s, receipt, _job = _run("torch", _env("torch", 10), loop_elf, Flaky())
    assert calls["n"] == 2 and receipt.claim.exit_code.kind == "Halted"
    jax_receipt = _run("jax", _env("jax", 10), loop_elf)[1]
    assert _hex(receipt.claim.digest()) == _hex(jax_receipt.claim.digest())

    calls["n"] = 0
    Flaky.fail = 10
    with pytest.raises(RuntimeError, match="transient fault"):
        _run("torch", _env("torch", 10), loop_elf, Flaky())
    assert calls["n"] == 3  # the first try and max_retries = 2


# -- the union tree -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_union_tree_over_coproc_receipts(loop_elf, n):
    """The job's union receipt is the MerkleMountainAccumulator root of
    the coprocessor receipts in their order.  With one receipt it is that
    receipt, as in the JAX package; with more, the port's union claims
    bind Assumption digests and the JAX ones the bare claims."""
    def run(pkg):
        R = _mod(pkg, "zkvm.receipt")
        coproc = [R.FakeReceipt(_claim_stub(pkg, i)) for i in range(n)]
        _s, receipt, job = _run(pkg, _env(pkg, 10), loop_elf,
                                coproc_receipts=coproc)
        drv = _mod(pkg, "zkvm.recursion_driver")
        mmr = drv.MerkleMountainAccumulator(
            merge=_mod(pkg, "zkvm.prover").DevModeProver().union)
        for r in coproc:
            mmr.insert(r)
        return (_hex(job.union_receipt.claim.digest()),
                _hex(mmr.root().claim.digest()),
                _hex(receipt.claim.digest()))
    got = _both(run)
    assert got["torch"][0] == got["torch"][1]
    assert got["torch"][2] == got["jax"][2]
    assert (got["torch"][0] == got["jax"][0]) == (n == 1)


class _SlowFirstKeccak:
    """A DevModeProver whose first keccak request ends last."""

    def __new__(cls, pkg, first):
        base = _mod(pkg, "zkvm.prover").DevModeProver

        class Slow(base):
            def prove_keccak(self, request):
                if bytes(request["claim_digest"]) == first:
                    time.sleep(0.3)
                return super().prove_keccak(request)

        return Slow()


@pytest.mark.parametrize("batches", [(3,), (3, 2), (3, 2, 1)])
@pytest.mark.parametrize("stream", [False, True])
def test_keccak_guest_assumption_resolves_in_guest_order(batches, stream):
    """The keccak guest assumes the union root of its batches' claims; the
    port's job proves the batches (the first one last), merges them in the
    guest's order and resolves the assumption, for any number of
    batches.  The JAX job does so for one batch only."""
    kg = _mod("torch", "keccak_guest")
    elf, inputs, root_claim = kg.build(batches)
    first = np.asarray(_mod("torch", "circuit.keccak")
                       .compute_keccak_digest(inputs[0]), np.uint32).tobytes()

    def run(pkg):
        E = _mod(pkg, "zkvm.exec")
        session, receipt, job = _run(
            pkg, E.ExecutorEnv(segment_po2=16), elf,
            _SlowFirstKeccak(pkg, first), num_accel=3, stream_keccak=stream)
        return (_hex(job.union_receipt.claim.digest()),
                _hex(receipt.claim.digest()),
                len(receipt.claim.output.value.assumptions.value.items),
                len(job.coproc_receipts), session)
    got = _both(run)
    union, digest, left, count, session = got["torch"]
    assert union == _hex(root_claim) and left == 0 and count == len(batches)
    assert session.pending_keccaks == [] if stream else \
        len(session.pending_keccaks) == len(batches)
    # the claim of the session executed with its requests kept
    E, R = _mod("torch", "zkvm.exec"), _mod("torch", "zkvm.receipt")
    queued = E.ExecutorImpl(E.ExecutorEnv(segment_po2=16), elf).run()
    assert digest == _hex(R.session_claim(queued).digest())
    if len(batches) == 1:
        assert got["jax"][:4] == got["torch"][:4]
    else:
        assert got["jax"][2] == 1  # left assumed: its union is another claim


# -- config, remote workers, assets -------------------------------------------------

DEFAULT_TOML = """
version = 1

[api]
listen = "127.0.0.1:0"

[manager]
listen = "127.0.0.1:0"

[executor]
count = 1

[[prover]]
subscribe = ["preflight", "prove-segment", "prove-keccak", "lift", "join",
             "union", "resolve", "unwrap", "shrink-wrap"]
count = 2
[prover.simulate]
lift = 0.01
join = 0.02

[storage]
path = "/var/lib/risc0"
assets = "127.0.0.1:0"
"""


def test_load_config_equal_jax():
    def run(pkg):
        cfg = _mod(pkg, "parallel.config").load_config(DEFAULT_TOML)
        return (cfg.version, vars(cfg.api), vars(cfg.manager),
                vars(cfg.executor), vars(cfg.storage),
                [(p.manager, p.count, [k.value for k in p.subscribe],
                  p.simulate) for p in cfg.provers])
    got = _both(run)
    assert got["torch"] == got["jax"]
    cfg = _mod("torch", "parallel.config")
    with pytest.raises(ValueError, match="version"):
        cfg.load_config("version = 2\n")
    with pytest.raises(ValueError, match="unknown task kind"):
        cfg.load_config('version = 1\n[[prover]]\nsubscribe = ["x"]\n')


def test_launch_cluster_runs_the_prover_it_is_given(loop_elf):
    """Pools without [prover.simulate] run the given prover; a pool with
    it, or any pool when no prover is given, runs the DevModeProver."""
    cfg = _mod("torch", "parallel.config")
    S = _mod("torch", "parallel.scheduler")
    Pm = _mod("torch", "zkvm.prover")
    seen = []

    class Spy(Pm.DevModeProver):
        def lift(self, sr):
            seen.append("lift")
            return super().lift(sr)

    toml = """
version = 1
[executor]
count = 1
[[prover]]
count = 1
subscribe = ["preflight"]
[[prover]]
count = 2
subscribe = ["prove-segment", "lift", "join", "union", "resolve", "unwrap"]
"""
    for prover, lifts in ((Spy(), 30), (None, 0)):
        seen.clear()
        cluster = cfg.launch_cluster(cfg.load_config(toml), prover)
        try:
            job = S.ProofJob(cluster.factory, prover or Pm.DevModeProver(),
                             _env("torch", MANY), loop_elf,
                             split_preflight=True)
            session, receipt = job.run()
        finally:
            cluster.stop()
        assert len(seen) == lifts
        assert np.array_equal(receipt.claim.digest(), _mod(
            "torch", "zkvm.receipt").session_claim(session).digest())
    seen.clear()
    simulated = cfg.load_config(toml + "[prover.simulate]\nlift = 0.001\n")
    cluster = cfg.launch_cluster(simulated, Spy())
    try:
        job = S.ProofJob(cluster.factory, Pm.DevModeProver(),
                         _env("torch", 10), loop_elf, split_preflight=True)
        job.run()
    finally:
        cluster.stop()
    assert seen == []


def test_remote_worker_and_asset_server(loop_elf, tmp_path):
    """A [[prover]] with a manager address pulls tasks over TCP; with
    [storage].assets the segments travel as content-addressed refs."""
    cfg = _mod("torch", "parallel.config")
    S = _mod("torch", "parallel.scheduler")
    A = _mod("torch", "parallel.assets")
    Pm = _mod("torch", "zkvm.prover")
    cluster = cfg.launch_cluster(cfg.load_config(f"""
version = 1
[manager]
listen = "127.0.0.1:0"
[executor]
count = 1
[storage]
path = "{tmp_path}"
assets = "127.0.0.1:0"
"""))
    try:
        port = cluster.factory_server.addr[1]
        remote = cfg.launch_cluster(cfg.load_config(f"""
version = 1
[[prover]]
manager = "127.0.0.1:{port}"
subscribe = ["prove-segment", "lift", "join", "union", "resolve"]
"""))
        try:
            job = S.ProofJob(cluster.factory, Pm.DevModeProver(),
                             _env("torch", 1024 * 100), loop_elf,
                             asset_addr=cluster.asset_addr)
            session, receipt = job.run()
        finally:
            remote.stop()
        assert len(session.segments) > 1
        assert np.array_equal(receipt.claim.digest(), _mod(
            "torch", "zkvm.receipt").session_claim(session).digest())
        assert len(list(tmp_path.iterdir())) == len(session.segments)
        client = A.AssetClient(cluster.asset_addr)
        try:
            digest = client.put(b"payload")
            assert client.has(digest) and client.get(digest) == b"payload"
            assert digest == A.digest_of(b"payload")
            with pytest.raises(KeyError):
                client.get("00" * 32)
        finally:
            client.close()
    finally:
        cluster.stop()


def test_remote_worker_error_propagates():
    S = _mod("torch", "parallel.scheduler")
    remote = _mod("torch", "parallel.remote")
    factory = S.Factory()
    server = remote.FactoryServer(factory)

    def bad(task):
        raise ValueError("worker exploded")

    worker = remote.RemoteWorker(server.addr, [S.TaskKind.EXECUTE], bad,
                                 "bad").start()
    try:
        factory.submit(S.Task(S.TaskKind.EXECUTE, job_id=1, payload=None))
        done = factory.job_channel(1).get(timeout=10)
        assert "exploded" in str(done.error)
    finally:
        worker.stop()
        server.close()


def test_make_local_pools_default_prover(monkeypatch):
    S = _mod("torch", "parallel.scheduler")
    Pm = _mod("torch", "zkvm.prover")
    built = []
    real = Pm.get_prover_server
    monkeypatch.setattr(Pm, "get_prover_server",
                        lambda *a, **k: built.append(real(*a, **k))
                        or built[-1])
    for dev in ("1", ""):
        monkeypatch.setenv("RISC0_DEV_MODE", dev)
        for w in S.make_local_pools(S.Factory(), num_cpu=1, num_accel=1,
                                    device="cpu"):
            w.stop()
    assert [type(p).__name__ for p in built] == ["DevModeProver",
                                                 "ProverImpl"]


# -- first use from several threads ---------------------------------------------------

def _race(fn, n=8):
    """Call fn from n threads released at once; their results."""
    gate, out = threading.Barrier(n), [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def call(i):
        gate.wait(timeout=10)
        out[i] = fn()
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def _slow_counter(count, value):
    def fn(*_a):
        count.append(1)
        time.sleep(0.05)
        return value
    return fn


def test_kernel_library_builds_once_under_threads(monkeypatch):
    build = _mod("torch", "hal.cuda.build")
    builds, lib = [], object()
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_build", _slow_counter(builds, "lib.so"))
    monkeypatch.setattr(build, "_load", lambda path: lib)
    assert _race(build.library) == [lib] * 8
    assert len(builds) == 1


@pytest.mark.parametrize("module,fn,builder", [
    ("circuit.rv32im.accum_device", "accum_graph", "build_accum_graph"),
    ("circuit.rv32im.exec_device", "exec_graph", "build_exec_graph")])
def test_witgen_graphs_build_once_under_threads(monkeypatch, module, fn,
                                                builder):
    m = _mod("torch", module)
    count, graph = [], object()
    monkeypatch.setattr(m, "_GRAPH", None)
    monkeypatch.setattr(m, builder, _slow_counter(count, graph))
    assert _race(getattr(m, fn)) == [graph] * 8
    assert len(count) == 1


def test_witgen_program_caches_load_once_under_threads(monkeypatch):
    native = _mod("torch", "zkvm.native")
    loads = []
    real = native._load
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load",
                        lambda: loads.append(1) or time.sleep(0.05) or real())
    for module, fn in (("circuit.recursion.prove", "_progs"),
                       ("circuit.rv32im.witgen", "_programs")):
        m = _mod("torch", module)
        monkeypatch.setattr(m, "_cache", {})
        got = _race(getattr(m, fn))
        assert all(g is got[0] and "lib" in g for g in got)
    assert len(loads) == 1


def _stub_graph():
    return type("G", (), {"out_cols": [1, 2], "bad": 3, "delta_sites": [],
                          "data_cols": [1], "glob_sites": []})()


@pytest.mark.parametrize("module,fn,graph_fn,key", [
    ("circuit.rv32im.accum_device", "_plans", "accum_graph", "full"),
    ("circuit.rv32im.exec_device", "_plans_exec", "exec_graph", "p2")])
def test_witgen_plans_build_once_under_threads(monkeypatch, module, fn,
                                               graph_fn, key):
    m = _mod("torch", module)
    count, graph = [], _stub_graph()
    monkeypatch.setattr(m, graph_fn, lambda: graph)
    if fn == "_plans":
        monkeypatch.setattr(m, "_PLANS", None)

    def plan(*_a):
        count.append(1)
        time.sleep(0.05)
        return type("P", (), {"groups": []})()
    monkeypatch.setattr(m, "ExecPlan", plan)
    got = _race(getattr(m, fn))
    plans = [g[1] if isinstance(g, tuple) else g for g in got]
    assert all(p is plans[0] and key in p for p in plans)
    assert len(count) == 2


@pytest.mark.parametrize("module,fn,cls,plans_fn,name", [
    ("circuit.rv32im.accum_device", "_device_plan", "_DevicePlan",
     "_plans", "full"),
    ("circuit.rv32im.exec_device", "_exec_device_plan", "_ExecDevicePlan",
     "_plans_exec", "p2")])
def test_device_plans_upload_once_under_threads(monkeypatch, module, fn,
                                                cls, plans_fn, name):
    m = _mod("torch", module)
    count, dp = [], object()
    plans = {name: object()}
    monkeypatch.setattr(m, "_DEVICE_PLANS", {})
    monkeypatch.setattr(m, plans_fn, lambda: (
        plans if plans_fn == "_plans" else (None, plans)))
    monkeypatch.setattr(m, cls, _slow_counter(count, dp))
    assert _race(lambda: getattr(m, fn)(name, "cpu")) == [dp] * 8
    assert len(count) == 1
