"""The examples over the port (risc0_tpu_torch/examples) against the JAX
examples (examples/*.py) on the same inputs, on the CPU in dev mode.

For each example: the guest ELF, the image ID, the journal and the exit
code of the port's run equal the JAX example's, and the port's
``main(["--device", "cpu"])`` runs to its end.  Each JAX example is
loaded by file, as tests/test_ecdsa_example.py does, and driven through
its builders and the JAX package's executor (its ``main`` would set
RISC0_DEV_MODE in this process).  Composition's guest B differs by
design (the port's GuestEnv commits its assumption); with that fold
stubbed it is the JAX ELF byte for byte.
"""

import hashlib
import importlib
import importlib.util
import struct
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
LOOP_ELF = (REPO / "guests" / "loop.bin").read_bytes()


def _jax_example(name):
    """examples/<name>.py, loaded with RISC0_DEV_MODE held for its import
    (three examples set it as a default when imported)."""
    key = f"jax_example_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RISC0_DEV_MODE", "1")
            spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def _port_example(name):
    return importlib.import_module(f"risc0_tpu_torch.examples.{name}")


_RUNS = {}


def _port_run(name, *argv):
    """The port example's main on the CPU, in dev mode, once per argv."""
    key = (name, argv)
    if key not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("RISC0_REAL_PROVE", raising=False)
            mp.delenv("RISC0_DEV_MODE", raising=False)
            mp.delenv("BONSAI_API_URL", raising=False)
            _RUNS[key] = _port_example(name).main(
                [*argv, "--device", "cpu"])
    return _RUNS[key]


def _jax_exec(elf, stdin=b"", po2=16, **env_kw):
    """(image ID, session) of the JAX package's executor."""
    from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl

    ex = ExecutorImpl(ExecutorEnv(segment_po2=po2, **env_kw)
                      .write_slice(stdin), elf)
    return ex.compute_image_id(), ex.run()


def _assert_same(port, elf, image_id, session):
    assert port["elf"] == elf
    assert np.array_equal(port["image_id"], image_id)
    assert bytes(port["session"].journal) == bytes(session.journal)
    assert tuple(port["session"].exit_code) == tuple(session.exit_code)


EXAMPLES = ("hello_world", "factors", "password_checker", "sha", "prorata",
            "ecdsa", "composition", "prover_api", "bonsai_remote",
            "keccak_coprocessor", "cluster", "povw", "profiling")


def test_every_example_has_a_port():
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == \
        sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_runs_to_its_end_on_the_cpu(name, tmp_path):
    if name == "profiling":
        out = _port_example(name).main([str(tmp_path / "guest.pb"),
                                        "--device", "cpu"])
    else:
        out = _port_run(name)
    if name == "bonsai_remote":
        assert out["status"]["status"] == "SUCCEEDED"
    else:
        assert out["session"].exit_code[0] == "Halted"


# -- the guests authored by the examples --------------------------------------

# (example, port argv, JAX guest builder, stdin); the password and
# prorata inputs that the guest rejects halt with exit code 1 in both
_GUESTS = {
    "hello_world": ((), lambda J, T: J.build_guest(T.MESSAGE), lambda T: b""),
    "factors": ((), lambda J, T: J.build_guest(),
                lambda T: struct.pack("<II", 3141592653, 2718281829)),
    "factors (prime)": (("2", "7"), lambda J, T: J.build_guest(),
                        lambda T: struct.pack("<II", 2, 7)),
    "password_checker": ((), lambda J, T: J.build_guest(17),
                         lambda T: b"s3cret-passphrase"),
    "password_checker (short)": (("short",), lambda J, T: J.build_guest(5),
                                 lambda T: b"short"),
    "password_checker (no digit)": (
        ("nodigitshere",), lambda J, T: J.build_guest(12),
        lambda T: b"nodigitshere"),
    "sha": ((), lambda J, T: J.build_guest(33),
            lambda T: b"proving hashes on the MXU's watch"),
    "prorata": ((), lambda J, T: J.build_guest(),
                lambda T: struct.pack("<IIII", 0xA11CE, 50_000, 137, 10_000)),
    "prorata (overflow)": (
        ("70000", "70000", "3"), lambda J, T: J.build_guest(),
        lambda T: struct.pack("<IIII", 0xA11CE, 70_000, 70_000, 3)),
}


@pytest.mark.parametrize("case", sorted(_GUESTS))
def test_guest_equals_the_jax_example(case):
    name = case.split(" ")[0]
    argv, build, stdin = _GUESTS[case]
    J, T = _jax_example(name), _port_example(name)
    port = _port_run(name, *argv)
    _assert_same(port, *((build(J, T),) + _jax_exec(build(J, T), stdin(T))))


def test_factors_trivial_factor_is_rejected_as_in_the_jax_example():
    J = _jax_example("factors")
    port = _port_run("factors")
    _, want = _jax_exec(J.build_guest(), struct.pack("<II", 1, 2718281829))
    assert port["rejected"].exit_code == want.exit_code == ("Halted", 1)


def test_ecdsa_session_equals_the_jax_example():
    J, T = _jax_example("ecdsa"), _port_example("ecdsa")
    msg = T.MESSAGE.encode()
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % J.N
    priv = int.from_bytes(hashlib.sha256(b"example key").digest(),
                          "big") % J.N
    qx, qy = J._ec_mul(priv, J.G)
    r, s = J._sign(priv, z)
    stdin = msg + J._le(qx) + J._le(qy) + J._le(r) + J._le(s)
    assert T.stdin_for(msg, T.example_key()) == (stdin, (qx, qy))
    elf = J.build_guest(len(msg))
    image_id, session = _jax_exec(elf, stdin, po2=17)
    port = _port_run("ecdsa")
    _assert_same(port, elf, image_id, session)
    assert bytes(session.journal) == \
        J._le(qx) + J._le(qy) + hashlib.sha256(msg).digest()
    # two segments of po2 17 in both
    assert [s.po2 for s in port["session"].segments] == \
        [s.po2 for s in session.segments] == [17, 17]
    bad = bytearray(stdin)
    bad[-1] ^= 1
    _, want = _jax_exec(elf, bytes(bad), po2=17)
    assert port["rejected"].exit_code == want.exit_code == ("Halted", 1)


# tests/test_ecdsa_example.py's three tampered signatures
_ECDSA_MSG = b"signed for the test suite"
_ECDSA_PRIV = 0x7E57_00D1_CE5E_C2E7


@pytest.mark.parametrize("case", ["s bit flipped", "another key's",
                                  "s = 0"])
def test_ecdsa_tampered_signature_is_rejected_as_in_the_jax_example(case):
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl

    J, T = _jax_example("ecdsa"), _port_example("ecdsa")
    z = int.from_bytes(hashlib.sha256(_ECDSA_MSG).digest(), "big") % J.N
    qx, qy = J._ec_mul(_ECDSA_PRIV, J.G)
    assert T._ec_mul(_ECDSA_PRIV, T.G) == (qx, qy)
    r, s = J._sign(_ECDSA_PRIV, z)
    if case == "s bit flipped":
        s ^= 1
    elif case == "another key's":
        r, s = J._sign((_ECDSA_PRIV * 7) % J.N, z)
        assert T._sign((_ECDSA_PRIV * 7) % T.N, z) == (r, s)
    else:
        s = 0
    stdin = _ECDSA_MSG + J._le(qx) + J._le(qy) + J._le(r) + J._le(s)
    elf = T.build_guest(len(_ECDSA_MSG))
    assert elf == J.build_guest(len(_ECDSA_MSG))
    _, want = _jax_exec(elf, stdin, po2=17)
    got = ExecutorImpl(ExecutorEnv(segment_po2=17).write_slice(stdin),
                       elf).run()
    assert got.exit_code == want.exit_code == ("Halted", 1)


def test_composition_guests_equal_the_jax_example_but_the_fold(monkeypatch):
    from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl
    from risc0_tpu.zkvm.prover import DevModeProver
    from risc0_tpu_torch.zkvm import exec as texec
    from risc0_tpu_torch.zkvm.guest_env import GuestEnv

    J, T = _jax_example("composition"), _port_example("composition")
    port = _port_run("composition")
    # guest A verifies nothing: the same ELF, image ID and journal
    elf_a = J.build_committer(T.VALUE)
    image_a, session_a = _jax_exec(elf_a)
    assert port["elf_a"] == elf_a
    assert np.array_equal(port["image_a"], image_a)
    assert port["receipt_a"].journal == bytes(session_a.journal)
    # guest B commits its assumption in the port only
    assert port["elf_b"] != J.build_composer()
    monkeypatch.setattr(GuestEnv, "_record_assumption",
                        lambda self, tok: None)
    stubbed = T.build_composer()
    assert stubbed == J.build_composer()
    assert np.array_equal(
        texec.ExecutorImpl(texec.ExecutorEnv(), stubbed).compute_image_id(),
        ExecutorImpl(ExecutorEnv(), J.build_composer()).compute_image_id())
    monkeypatch.undo()
    assert T.build_composer() == port["elf_b"]
    # B's journal and exit code, A's receipt assumed on both sides
    receipt_a = DevModeProver().prove_session(session_a).receipt
    env = (ExecutorEnv(segment_po2=16)
           .write_slice(T.composer_input(receipt_a.claim().digest(),
                                         T.VALUE))
           .add_assumption(receipt_a))
    session_b = ExecutorImpl(env, J.build_composer()).run()
    assert bytes(port["session"].journal) == bytes(session_b.journal) == \
        (T.VALUE ** 2).to_bytes(4, "little")
    assert port["session"].exit_code == session_b.exit_code == ("Halted", 0)
    # the port's receipt drops the assumption it resolved
    assert port["receipt"].claim().output.value.assumptions.value.items == []


@pytest.mark.parametrize("stream", [False, True], ids=["queued", "streamed"])
def test_keccak_coprocessor_union_claim_equals_the_jax_one(stream):
    from risc0_tpu.parallel.scheduler import (Factory, ProofJob,
                                              make_local_pools)
    from risc0_tpu.zkvm.exec import ExecutorEnv
    from risc0_tpu.zkvm.prover import DevModeProver

    J = _jax_example("keccak_coprocessor")
    port = _port_run("keccak_coprocessor", *(["--stream"] if stream else []))
    elf, claim = J.build_guest()
    assert port["elf"] == elf
    assert np.array_equal(port["batch_claim"], claim)
    factory, prover = Factory(), DevModeProver()
    workers = make_local_pools(factory, prover, num_cpu=1, num_accel=2)
    try:
        job = ProofJob(factory, prover, ExecutorEnv(segment_po2=15), elf,
                       stream_keccak=stream)
        session, _receipt = job.run()
    finally:
        for w in workers:
            w.stop()
    # one batch: the port's union claim (receipt.union_claim) is the JAX one
    assert np.array_equal(port["union_claim"],
                          np.asarray(job.union_receipt.claim.digest(),
                                     np.uint32))
    assert port["session"].journal == session.journal == \
        b"keccak-accelerated!"


# -- the examples over the loop guest -----------------------------------------

# (example, input, segment po2) of the loop guest
_LOOP = {"prover_api": (25, 16), "cluster": (1024 * 494 + 818, 16),
         "povw": (1024 * 494 + 818, 16)}


@pytest.mark.parametrize("name", sorted(_LOOP))
def test_loop_session_equals_the_jax_example(name):
    count, po2 = _LOOP[name]
    port = _port_run(name)
    kw = {}
    if name == "povw":
        from risc0_tpu.zkvm.povw import PovwJobId

        kw["povw_job_id"] = PovwJobId(log=0x1234_5678_9ABC_DEF0, job=1)
    image_id, session = _jax_exec(LOOP_ELF, count.to_bytes(4, "little"),
                                  po2, **kw)
    assert port["elf"] == LOOP_ELF
    if "image_id" in port:
        assert np.array_equal(port["image_id"], image_id)
    assert port["session"].journal == bytes(session.journal)
    assert tuple(port["session"].exit_code) == tuple(session.exit_code)
    assert len(port["session"].segments) == len(session.segments)


def test_povw_work_log_equals_the_jax_one():
    from risc0_tpu.zkvm.povw import PovwJobId, WorkLog, session_work
    from risc0_tpu.zkvm.povw_tree import WorkSet

    port = _port_run("povw")
    job = PovwJobId(log=0x1234_5678_9ABC_DEF0, job=1)
    _, session = _jax_exec(LOOP_ELF, (1024 * 494 + 818).to_bytes(4, "little"),
                           povw_job_id=job)
    work = session_work(session, job)
    assert (port["work"].value, port["work"].nonce_min.segment,
            port["work"].nonce_max.segment) == \
        (work.value, work.nonce_min.segment, work.nonce_max.segment)
    log = WorkLog(log_id=job.log)
    log.record(work)
    assert np.array_equal(port["log_commit"], log.commit())
    assert port["onchain_root"] == WorkSet({job.log: log.to_tree()}).commit()


def test_bonsai_receipt_equals_the_jax_service_one(monkeypatch):
    from risc0_tpu.zkvm.api_server import serve
    from risc0_tpu.zkvm.bonsai import Client

    port = _port_run("bonsai_remote")
    monkeypatch.setenv("RISC0_DEV_MODE", "1")
    with tempfile.TemporaryDirectory() as storage:
        srv = serve(port=0, storage=storage)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            client = Client.from_parts(
                f"http://127.0.0.1:{srv.server_address[1]}")
            client.upload_img("loop-img", LOOP_ELF)
            input_id = client.upload_input((42).to_bytes(4, "little"))
            session = client.create_session("loop-img", input_id)
            while (res := session.status(client))["status"] == "RUNNING":
                time.sleep(0.05)
            receipt = client.download(res["receipt_url"])
        finally:
            srv.shutdown()
            srv.server_close()
    assert port["elf"] == LOOP_ELF
    assert port["status"]["stats"] == res["stats"]
    assert port["receipt"] == receipt


def test_profiling_pprof_equals_the_jax_one(tmp_path):
    from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl

    out = tmp_path / "guest.pb"
    port = _port_example("profiling").main([str(out), "--device", "cpu"])
    env = ExecutorEnv(segment_po2=16).write_slice(
        (20000).to_bytes(4, "little")).enable_profiler()
    session = ExecutorImpl(env, LOOP_ELF).run()
    assert out.read_bytes() == port["pprof"] == env.profiler.encode_to_vec()
    assert port["session"].user_cycles == session.user_cycles


# -- real proves --------------------------------------------------------------
# The ecdsa session (two segments of po2 17) is proved for real on the card
# only (chip_smoke.py phase 14): on the CPU each of its segments would take
# several times the po2 14 proves below, beyond the slow suite's minutes.

@pytest.mark.slow
def test_composition_real_prove_on_the_cpu(monkeypatch):
    """Both guests proved for real by the port on the CPU (two po2 14
    segments): B's composite receipt carries A's receipt and verifies."""
    from risc0_tpu_torch.zkvm.receipt import VerifierContext

    monkeypatch.setenv("RISC0_REAL_PROVE", "1")
    out = _port_example("composition").main(["--device", "cpu"])
    receipt = out["receipt"]
    assert receipt.inner.kind == "composite"
    attached = receipt.inner.value.assumption_receipts
    assert [np.asarray(r.claim().digest(), np.uint32).tobytes()
            for r in attached] == \
        [np.asarray(out["receipt_a"].claim().digest(), np.uint32).tobytes()]
    receipt.verify(out["image_b"], VerifierContext(dev_mode=False))
