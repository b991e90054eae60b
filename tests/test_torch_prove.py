"""End-to-end checks of the torch prover on the CPU against the JAX package.

  * fib: the port's seal at po2 6 is word for word the JAX seal (saved in
    tests/data/fib_seal_po2_6_seed_0.npy; the live JAX prove compiles for
    minutes, so that comparison is marked slow, as is the JAX verifier's
    run on it), and the port's verifier takes it;
  * rv32im eval_check: the port's range-plan evaluator equals the JAX
    package's numpy plan oracle (ir_exec.execute_plan_np) on random groups;
  * rv32im witgen: the port's wrapper gives the reference's columns;
  * rv32im seal (slow): a real loop-guest segment proved by the port is
    accepted by both verifiers and a corrupted one rejected by both;
  * the port imports and proves with jax made unimportable.

Field arithmetic is exact, so every comparison is bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu_torch.circuit import fib
from risc0_tpu_torch.verify.verifier import VerificationError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIB_SEAL = os.path.join(REPO, "tests", "data", "fib_seal_po2_6_seed_0.npy")


@pytest.fixture(scope="module")
def fib_seal():
    return fib.prove(po2=6, seed=0)


def test_fib_seal_is_the_jax_seal(fib_seal):
    assert np.array_equal(fib_seal, np.load(FIB_SEAL))


def test_fib_seal_verifies_and_corruption_is_rejected(fib_seal):
    out = fib.verify(fib_seal)
    assert np.array_equal(out, fib.witgen(6)[2])
    for idx in (5, len(fib_seal) // 2):  # the po2 word, a Merkle opening
        bad = np.array(fib_seal)
        bad[idx] ^= 1
        with pytest.raises(VerificationError):
            fib.verify(bad)


@pytest.mark.slow
def test_reference_verifier_accepts_port_fib_seal(fib_seal):
    from risc0_tpu.circuit import fib as rfib

    assert np.array_equal(rfib.verify(fib_seal), fib.witgen(6)[2])


@pytest.mark.slow
def test_fib_seal_equals_live_jax_prove(fib_seal):
    from risc0_tpu.circuit import fib as rfib

    assert np.array_equal(fib_seal, np.asarray(rfib.prove(po2=6, seed=0)))


def test_eval_check_matches_plan_oracle():
    """The port's range-plan evaluator against the JAX package's numpy
    level-plan oracle, as test_range_eval_check_matches_plan_oracle runs
    the JAX range evaluator."""
    from risc0_tpu.circuit import ir_exec
    from risc0_tpu.circuit.rv32im.circuit import load_circuit as ref_circuit
    from risc0_tpu_torch.circuit import ir_range
    from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit
    from risc0_tpu_torch.convert import to_numpy, to_torch

    c = ref_circuit()
    po2 = 4
    cycles = 1 << po2
    domain = cycles * 4
    rng = np.random.default_rng(11)
    accum = rng.integers(0, RF.P, (103, domain), dtype=np.uint32)
    data = rng.integers(0, RF.P, (211, domain), dtype=np.uint32)
    mix_g = rng.integers(0, RF.P, (36,), dtype=np.uint32)
    out_g = rng.integers(0, RF.P, (90,), dtype=np.uint32)
    poly_mix = rng.integers(0, RF.P, (4,), dtype=np.uint32)
    pm = c.mix_pows(poly_mix)

    plan = ir_exec.build_plan(c)
    gv = np.array([(out_g if b == 2 else mix_g)[i]
                   for b, i in plan.global_specs], np.uint32)
    tot = np.zeros((domain, 4), np.uint32)
    for start in range(0, domain, 32):
        tapm = ir_exec.build_tap_matrix_np(plan, {0: accum, 1: data}, start,
                                           32, domain)
        tot[start:start + 32] = ir_exec.execute_plan_np(plan, tapm, gv, pm)
    w = RF.s_encode(RF.ROU_FWD[po2 + 2])
    kpow = RF.s_pow(RF.s_encode(3), cycles)
    wq = RF.s_pow(w, cycles)
    ys, cw = [], RF.R % RF.P
    for _ in range(4):
        ys.append(RF.s_inv(RF.s_sub(RF.s_mul(kpow, cw), RF.R % RF.P)))
        cw = RF.s_mul(cw, wq)
    expected = RF.mul_np(tot, np.tile(np.array(ys, np.uint32),
                                      domain // 4)[:, None]).T

    tc = load_circuit()
    assert np.array_equal(tc.mix_pows(poly_mix), pm)
    rp = ir_range.build_range_plan(tc)
    assert ir_range.plan_buf_ids(rp) == [0, 1]
    gv_r = np.array([(out_g if b == 2 else mix_g)[i]
                     for b, i in rp.global_specs], np.uint32)
    for chunk in (16, 64):  # several chunks with wrap-around taps, and one
        fn = ir_range.make_eval_check(rp, po2, chunk=chunk)
        got = to_numpy(fn((to_torch(accum), to_torch(data)), gv_r, pm))
        assert np.array_equal(got, expected)


@pytest.mark.slow
def test_poly_ext_matches_reference():
    from risc0_tpu.circuit.rv32im.circuit import load_circuit as ref_circuit
    from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit

    rng = np.random.default_rng(5)
    c, tc = ref_circuit(), load_circuit()
    poly_mix = rng.integers(0, RF.P, 4, dtype=np.uint32)
    eval_u = rng.integers(0, RF.P, (c.taps.tap_size, 4), dtype=np.uint32)
    out = rng.integers(0, RF.P, 90, dtype=np.uint32)
    mix = rng.integers(0, RF.P, 36, dtype=np.uint32)
    assert np.array_equal(tc.poly_ext(poly_mix, eval_u, out, mix),
                          c.poly_ext(poly_mix, eval_u, out, mix))


def _loop_segment(count=100):
    from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl

    with open(os.path.join(REPO, "guests", "loop.bin"), "rb") as f:
        elf = f.read()
    env = ExecutorEnv(segment_po2=16).write_slice(count.to_bytes(4, "little"))
    return ExecutorImpl(env, elf).run().segments[0]


def test_witgen_matches_reference():
    from risc0_tpu.circuit.rv32im import witgen as rw
    from risc0_tpu_torch.circuit.rv32im import witgen as tw

    seg = _loop_segment()
    rand_z = (5, 6, 7, 8)
    ref = rw.witgen_exec(seg, rand_z=rand_z)
    got = tw.witgen_exec(seg, rand_z=rand_z)
    assert got["rows"] == ref["rows"] == 1 << 14
    assert np.array_equal(got["data"], ref["data"])
    assert np.array_equal(got["global"], ref["global"])
    mix = np.random.default_rng(3).integers(0, RF.P, 36).astype(np.uint32)
    acc = tw.witgen_accum(got, mix)
    assert np.array_equal(acc, rw.witgen_accum(ref, mix))
    assert (acc[-4:, -1] == 0).all()  # the running sums cancel


def test_rv32im_verifier_rejects_garbage():
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal

    with pytest.raises(VerificationError):
        verify_rv32im_seal(np.zeros(0, np.uint32))
    with pytest.raises(VerificationError):
        verify_rv32im_seal(np.array([1, 2, 3], np.uint32))
    with pytest.raises(VerificationError):
        verify_rv32im_seal(np.array([2, 0, 0], np.uint32))


@pytest.mark.slow
def test_rv32im_seal_accepted_by_both_verifiers():
    """A real loop-guest segment (po2 14) proved by the port on the CPU."""
    from risc0_tpu.circuit.rv32im.verify import \
        verify_rv32im_seal as ref_verify
    from risc0_tpu.verify.verifier import VerificationError as RefError
    from risc0_tpu_torch.circuit.rv32im.prove import prove_segment
    from risc0_tpu_torch.circuit.rv32im.verify import verify_rv32im_seal

    seal = prove_segment(_loop_segment(), rand_z=(1, 2, 3, 4), device="cpu",
                         eval_chunk=1 << 12)
    assert len(verify_rv32im_seal(seal)) == 90
    assert len(ref_verify(seal)) == 90
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(VerificationError):
        verify_rv32im_seal(bad)
    with pytest.raises(RefError):
        ref_verify(bad)


_NO_JAX = """
import sys
sys.modules["jax"] = None
import numpy as np
import risc0_tpu_torch
from risc0_tpu_torch.circuit import fib
from risc0_tpu_torch.circuit.rv32im import prove, verify
seal = fib.prove(po2=6, seed=0)
fib.verify(seal)
assert np.array_equal(seal, np.load(sys.argv[1]))
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX, FIB_SEAL],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
