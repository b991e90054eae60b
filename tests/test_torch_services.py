"""The port's services against the JAX package: the protobuf IPC frames
(proto, _opts_msg, _env_msg) byte for byte, a client-server round trip on
the DevModeProver, the `port` CLI as a child server, one composite prove
of the loop guest's smallest segment through IPC with ProverImpl on the
CPU, the REST routes and the Bonsai client, RISC0_PROVER selection, and
the CLI's execute, id and dev-mode prove output (tests/test_ipc.py,
test_api_server.py, test_bonsai.py and test_zkvm_host.py are the JAX
package's own).
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

PKGS = {"jax": "risc0_tpu", "torch": "risc0_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = os.path.join(REPO, "guests", "loop.bin")


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


@pytest.fixture(scope="module")
def loop_elf():
    with open(LOOP, "rb") as f:
        return f.read()


def _env(pkg, count=10, **kw):
    return _mod(pkg, "zkvm.exec").ExecutorEnv(segment_po2=16, **kw) \
        .write_slice(count.to_bytes(4, "little"))


# -- frames -------------------------------------------------------------------

def test_proto_and_frames_equal_jax(loop_elf):
    def run(pkg):
        pr, ipc = _mod(pkg, "zkvm.proto"), _mod(pkg, "zkvm.ipc")
        Pm = _mod(pkg, "zkvm.prover")
        msg = (pr.uint(1, 300) + pr.bytes_field(2, b"abc") +
               pr.string(3, "xyz") + pr.packed(4, [1, 128, 300000]))
        opts = [ipc._opts_msg(Pm.ProverOpts(receipt_kind=k, dev_mode=d))
                for k in ("composite", "succinct", "groth16")
                for d in (False, True)]
        env = _env(pkg, 77)
        env.keccak_max_po2 = 15
        back, elf = ipc._env_from(ipc._env_msg(env, loop_elf))
        dig = ipc._digest_msg(np.arange(8, dtype=np.uint32) * 99)
        return (msg, pr.to_dict(msg), opts, ipc._env_msg(env, loop_elf),
                (back.segment_po2, back.keccak_max_po2, back.input,
                 elf == loop_elf), dig, ipc._digest_from(dig).tolist(),
                [(o.hashfn, o.receipt_kind, o.dev_mode)
                 for o in map(ipc._opts_from, opts)])
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][4] == (16, 15, (77).to_bytes(4, "little"), True)


def test_asset_roundtrip(tmp_path):
    import pickle

    ipc = _mod("torch", "zkvm.ipc")
    obj = {"x": np.arange(5), "y": b"bytes"}
    got = ipc.asset_decode(ipc.asset_encode(obj))
    assert np.array_equal(got["x"], obj["x"]) and got["y"] == b"bytes"
    p = tmp_path / "a.bin"
    p.write_bytes(pickle.dumps([1, 2, 3]))
    assert ipc.asset_decode(ipc.asset_path(str(p))) == [1, 2, 3]


# -- IPC round trips ------------------------------------------------------------

@pytest.fixture(scope="module")
def clients():
    out = {pkg: _mod(pkg, "zkvm.ipc").ApiClient(
        spawn=True, prover=_mod(pkg, "zkvm.prover").DevModeProver(),
        **({"device": "cpu"} if pkg == "torch" else {}))
        for pkg in PKGS}
    yield out
    for c in out.values():
        c.close()


def test_ipc_round_trip_equal_jax(clients, loop_elf, monkeypatch):
    monkeypatch.setenv("RISC0_DEV_MODE", "1")

    def run(pkg):
        c = clients[pkg]
        C = _mod(pkg, "zkvm.claims")
        R = _mod(pkg, "zkvm.receipt")
        env = _env(pkg)
        session, segments = c.execute(env, loop_elf)
        claim = R.session_claim(session)
        sc = R.segment_claim(session.segments[0], True,
                             C.ExitCode("Halted", 0), claim.output)
        sr = c.prove_segment(session.segments[0], sc)
        lifted = c.lift(sr)
        joined = c.join(lifted, lifted)
        resolved = c.resolve(joined, lifted)
        keccak = c.prove_keccak(np.arange(8, dtype=np.uint32), 14,
                                np.zeros(8, np.uint32), [])
        receipt = c.prove(env, loop_elf, _mod(pkg, "zkvm.prover").ProverOpts(
            receipt_kind="composite", dev_mode=True))
        image_id = _mod(pkg, "zkvm.exec").ExecutorImpl(
            env, loop_elf).compute_image_id()
        c.verify(receipt, image_id)
        with pytest.raises(RuntimeError, match="server error"):
            c.verify(receipt, np.zeros(8, np.uint32))
        with pytest.raises(RuntimeError, match="server error"):
            c.prove(_env(pkg), b"not an elf")
        return ([len(segments), segments[0].po2, session.exit_code[0]]
                + [np.asarray(r.claim.digest(), np.uint32).tobytes().hex()
                   for r in (sr, lifted, joined, resolved, keccak)]
                + [receipt.inner.kind, receipt.claim().digest().tobytes()
                   .hex(), c.compress(receipt).inner.kind])
    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == [1, 14, "Halted"]
    # the union's digest is the queue-3 difference (test_torch_host.py)
    union = clients["torch"].union(clients["torch"].prove_keccak(
        np.arange(8, dtype=np.uint32), 14, np.zeros(8, np.uint32), []),
        clients["torch"].prove_keccak(np.arange(8, dtype=np.uint32) + 1, 14,
                                      np.zeros(8, np.uint32), []))
    assert type(union.claim).__name__ == "UnionClaim"


def test_api_server_without_a_prover_needs_its_device():
    ipc = _mod("torch", "zkvm.ipc")
    assert ipc.ApiServer(device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device cuda"):
            ipc.ApiServer()


def test_subprocess_server_round_trip(loop_elf):
    """`port` CLI as the child server (reference r0vm --port), on the CPU;
    a child that cannot start (no card) raises instead of hanging."""
    ipc = _mod("torch", "zkvm.ipc")
    c = ipc.ApiClient(subprocess_server=True, device="cpu")
    try:
        session, segments = c.execute(_env("torch"), loop_elf)
        assert session.exit_code[0] == "Halted" and len(segments) == 1
    finally:
        c.close()
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        with pytest.raises(RuntimeError, match="exited"):
            ipc.ApiClient(subprocess_server=True)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def test_ipc_composite_prove_on_the_cpu_verifies(loop_elf, monkeypatch):
    """A real composite prove of the loop guest's smallest segment (po2
    14) through IPC with ProverImpl on the CPU: the receipt verifies
    against the image ID, and its claim is the JAX package's."""
    monkeypatch.delenv("RISC0_DEV_MODE", raising=False)
    ipc = _mod("torch", "zkvm.ipc")
    Pm = _mod("torch", "zkvm.prover")
    E = _mod("torch", "zkvm.exec")
    c = ipc.ApiClient(spawn=True, device="cpu")
    try:
        env = _env("torch")
        receipt = c.prove(env, loop_elf, Pm.ProverOpts(
            receipt_kind="composite"))
        image_id = E.ExecutorImpl(env, loop_elf).compute_image_id()
        c.verify(receipt, image_id)
    finally:
        c.close()
    assert receipt.inner.kind == "composite"
    (seg,) = receipt.inner.value.segments
    assert int(seg.seal[91]) == 14
    JE, JR = _mod("jax", "zkvm.exec"), _mod("jax", "zkvm.receipt")
    jsession = JE.ExecutorImpl(_env("jax"), loop_elf).run()
    assert np.array_equal(receipt.claim().digest(),
                          JR.session_claim(jsession).digest())
    bad = np.array(seg.seal)
    bad[len(bad) // 2] ^= 1
    seg.seal = bad
    with pytest.raises(_mod("torch", "zkvm.receipt").VerificationError):
        receipt.verify(image_id)


# -- REST and Bonsai ---------------------------------------------------------------

def _serve(pkg, tmp_path):
    kw = {"prover": _mod("torch", "zkvm.prover").DevModeProver()} \
        if pkg == "torch" else {}
    srv = _mod(pkg, "zkvm.api_server").serve(
        port=0, storage=str(tmp_path / pkg), **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _wait(fn):
    for _ in range(200):
        st = fn()
        if st["status"] != "RUNNING":
            return st
        time.sleep(0.05)
    raise TimeoutError(st)


def test_rest_routes_and_bonsai_equal_jax(tmp_path, loop_elf):
    import pickle

    def run(pkg):
        srv, url = _serve(pkg, tmp_path)
        try:
            B = _mod(pkg, "zkvm.bonsai")
            c = B.Client.from_parts(url)
            assert c.upload_img("loop", loop_elf) is False
            assert c.upload_img("loop", loop_elf) is True
            session = c.create_session("loop", c.upload_input(
                (25).to_bytes(4, "little")))
            res = _wait(lambda: session.status(c))
            receipt = pickle.loads(c.download(res["receipt_url"]))
            logs = json.loads(session.logs(c))
            ex = c.create_session("loop", c.upload_input(
                (7).to_bytes(4, "little")), execute_only=True)
            ex_res = _wait(lambda: ex.status(c))
            journal = ex.exec_only_journal(c)
            bad = c.create_session("missing", "missing")
            bad_res = _wait(lambda: bad.status(c))
            with pytest.raises(B.SdkErr, match="404"):
                c._get_json("/sessions/status/nope")
            with pytest.raises(B.SdkErr, match="501"):
                c.create_snark("whatever")
            with pytest.raises(B.SdkErr, match="404"):
                c._get_json("/receipts/stark/receipt/nope")
            session.stop(c)
            metrics = c._get_bytes("/metrics")
            spans = c._get_json("/spans")
            return (res["status"], res["stats"], receipt, logs,
                    ex_res["status"], ex_res["stats"], journal,
                    bad_res["status"], "error_msg" in bad_res,
                    c.quotas(), sorted(c.get_version()),
                    isinstance(metrics, bytes), sorted(spans))
        finally:
            srv.shutdown()
            srv.server_close()
    got = _both(run)
    assert got["torch"][:10] == got["jax"][:10]
    assert got["torch"][0] == "SUCCEEDED" and got["torch"][2]["kind"] == "fake"
    assert got["torch"][10] == ["compat_risc0", "risc0_tpu_torch"]
    assert got["torch"][11:] == got["jax"][11:]


def test_rest_service_proves_with_the_card_by_default(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("RISC0_DEV_MODE", raising=False)
    A = _mod("torch", "zkvm.api_server")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device cuda"):
            A.serve(port=0, storage=str(tmp_path))
    monkeypatch.setenv("RISC0_DEV_MODE", "1")
    srv = A.serve(port=0, storage=str(tmp_path))
    try:
        assert type(A.Handler.state.prover).__name__ == "DevModeProver"
    finally:
        srv.server_close()


# -- client selection -----------------------------------------------------------

def test_default_prover_selection(monkeypatch, loop_elf):
    monkeypatch.setenv("RISC0_DEV_MODE", "1")
    cl = _mod("torch", "zkvm.client")
    Pm = _mod("torch", "zkvm.prover")
    for name, cls in (("local", cl.LocalProver), ("ipc", cl.IpcProver),
                      ("bonsai", cl.ExternalProver)):
        monkeypatch.setenv("RISC0_PROVER", name)
        assert isinstance(cl.default_prover(device="cpu"), cls)
    monkeypatch.setenv("RISC0_PROVER", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        cl.default_prover()
    monkeypatch.delenv("RISC0_PROVER")
    local = cl.default_prover(device="cpu")
    assert isinstance(local.server, Pm.DevModeProver)
    info = local.prove(_env("torch"), loop_elf)
    jinfo = _mod("jax", "zkvm.client").LocalProver().prove(_env("jax"),
                                                           loop_elf)
    assert np.array_equal(info.receipt.claim().digest(),
                          jinfo.receipt.claim().digest())
    monkeypatch.setenv("RISC0_PROVER", "ipc")
    ipc = cl.default_prover(device="cpu")
    try:
        got = ipc.prove(_env("torch"), loop_elf)
    finally:
        ipc.close()
    assert got.receipt.inner.kind == "fake"
    assert np.array_equal(got.receipt.claim().digest(),
                          info.receipt.claim().digest())
    monkeypatch.delenv("RISC0_DEV_MODE")
    assert isinstance(cl.LocalProver(device="cpu").server, Pm.ProverImpl)


def test_external_prover_over_rest(tmp_path, loop_elf, monkeypatch):
    srv, url = _serve("torch", tmp_path)
    try:
        monkeypatch.setenv("RISC0_API_URL", url)
        st = _mod("torch", "zkvm.client").ExternalProver().prove(
            _env("torch", 12), loop_elf)
    finally:
        srv.shutdown()
        srv.server_close()
    assert st["status"] == "SUCCEEDED" and st["stats"]["segments"] == 1


# -- the CLI ----------------------------------------------------------------------

def _cli(pkg, *argv, env=None):
    res = subprocess.run([sys.executable, "-m", f"{PKGS[pkg]}.cli", *argv],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, **(env or {})),
                         timeout=300, check=False)
    return res.returncode, res.stdout.strip().splitlines()[-1:]


def test_cli_execute_id_and_dev_prove_equal_jax():
    dev = {"RISC0_DEV_MODE": "1"}
    for argv, env in ((("id", "--elf", LOOP), None),
                      (("execute", "--elf", LOOP, "--input-hex", "0a000000",
                        "--po2", "16"), None),
                      (("execute", "--elf", LOOP, "--input-hex",
                        (1024 * 40).to_bytes(4, "little").hex(), "--po2",
                        "15"), None),
                      (("prove", "--elf", LOOP, "--input-hex", "0a000000",
                        "--po2", "16"), dev)):
        got = _both(lambda pkg: _cli(pkg, *argv, env=env))
        assert got["torch"] == got["jax"], argv
        assert got["torch"][0] == 0 and got["torch"][1]
    rc, (line,) = _cli("torch", "prove", "--elf", LOOP, "--input-hex",
                       "0a000000", "--po2", "16", env=dev)
    assert json.loads(line)["kind"] == "fake"


def test_cli_help_lists_every_subcommand():
    res = subprocess.run([sys.executable, "-m", "risc0_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120, check=True)
    for cmd in ("execute", "id", "prove", "verify", "serve", "port", "new"):
        assert cmd in res.stdout


def test_cli_verify_and_new(tmp_path, capsys):
    cli = _mod("torch", "cli")
    seal = np.load(os.path.join(REPO, "tests", "data",
                                "rv32im_seal_po2_14.npy"))
    path = tmp_path / "seal.bin"
    np.asarray(seal, np.uint32).tofile(path)
    assert cli.main(["verify", "--seal", str(path), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    bad = np.array(seal, np.uint32)
    bad[len(bad) // 2] ^= 1
    bad.tofile(path)
    with pytest.raises(_mod("torch", "verify.verifier").VerificationError):
        cli.main(["verify", "--seal", str(path), "--device", "cpu"])
    assert cli.main(["new", "../evil", "--dest", str(tmp_path)]) == 1
    assert cli.main(["new", "myproof", "--dest", str(tmp_path)]) == 0
    root = tmp_path / "myproof"
    host = (root / "host.py").read_text()
    assert "risc0_tpu_torch" in host and "jax" not in host
    out = subprocess.run([sys.executable, "host.py"], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=f"{REPO}:.",
                                  CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert "journal: 42" in out.stdout and "receipt verified" in out.stdout
