"""The port's recursion layer on the CPU against the JAX package.

  * the recursion circuit's tap set and its PolyExtStep interpreter;
  * the range-plan eval_check of the recursion circuit (code group read as
    IR buffer 4) against the JAX package's numpy plan oracle, at two chunk
    sizes;
  * preflight, exec and accum witgen of a small program built with the JAX
    assembler (po2 11), under the same rng and mix;
  * that program's seal with rng default_rng(9) is byte for byte the JAX
    package's (tests/data/recursion_seal_asm_po2_11.npy; the live JAX prove
    takes minutes, so that comparison is marked slow), its control ID is
    JAX's, and the port's verifier takes it and rejects a flipped word;
  * the lift_rv32im_14 predicate in the port's preflight on a real segment
    seal, and on a tampered one;
  * the three golden succinct receipts of tests/test_golden.py verify in the
    port, and corrupted copies are rejected;
  * the allowed-control-IDs set, decode_claim, the suites by name, and the
    session claim of a keccak guest.

Field arithmetic is exact, so every comparison is bit for bit.  A lift of
the po2 14 seal on the CPU and the keccak_lift_14 control ID at po2 18 are
marked slow.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu_torch import field as F
from risc0_tpu_torch.circuit.recursion import prove as TP
from risc0_tpu_torch.circuit.recursion.preflight import RecursionPreflight
from risc0_tpu_torch.circuit.recursion.predicates import (load_own_program,
                                                          own_control_ids)
from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
from risc0_tpu_torch.zkvm.claims import Assumption, MaybePruned, UnionClaim
from risc0_tpu_torch.zkvm.receipt import (SuccinctReceipt, VerificationError,
                                          VerifierContext)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ASM_SEAL = os.path.join(DATA, "recursion_seal_asm_po2_11.npy")
SEGMENT_SEAL = os.path.join(DATA, "rv32im_seal_po2_14.npy")


def _asm_program():
    """The po2 11 program of tests/test_recursion_asm.py, built by the JAX
    assembler: read 8 words, sum their squares, write four globals."""
    from risc0_tpu.circuit.recursion.asm import Asm

    a = Asm()
    a.read_iop_header(8, k=1)
    vals = [a.read_iop_body(do_mont=True) for _ in range(8)]
    sq = [a.mul(v, v) for v in vals]
    tot = sq[0]
    for s in sq[1:]:
        tot = a.add(tot, s)
    ex = a.extract(tot, 0)
    outs = [a.add(ex, a.const(i)) for i in range(16)]
    for k in range(4):
        a.set_global(outs[4 * k], k)
    prog = a.program(11)
    inp = [int(x) for x in np.random.default_rng(6).integers(0, RF.P, 8)]
    return prog, inp


@pytest.fixture(scope="module")
def asm():
    jprog, inp = _asm_program()
    return jprog, TP.Program(jprog.code.ravel(), jprog.po2), inp


@pytest.fixture(scope="module")
def asm_seal(asm):
    _jprog, prog, inp = asm
    seal, out = TP.prove_program(prog, inp, rng=np.random.default_rng(9),
                                 device="cpu", eval_chunk=1 << 11)
    return seal, out


# -- circuit ----------------------------------------------------------------

def test_tapset_and_prover_circuit_match_jax():
    from risc0_tpu.circuit.recursion import circuit as JC
    from risc0_tpu_torch.circuit.recursion import circuit as TC

    want, got = JC.load_circuit().taps, TC.load_circuit().taps
    # reference taps.rs:4527-4531: 643 taps, 163 regs, 5 combos, 20 backs
    assert (got.tap_size, got.reg_count, got.combos_size,
            got.tot_combo_backs, got.group_size(1)) == (643, 163, 5, 20, 23)
    assert [dataclasses.astuple(r) for r in got.regs] == \
        [dataclasses.astuple(r) for r in want.regs]
    assert got.combos == want.combos
    pc = TC.load_prover_circuit()
    assert (pc.CIRCUIT_INFO, pc.OUTPUT_SIZE, pc.MIX_SIZE) == \
        (b"RECURSION:rev1v1", 32, 20)
    assert pc.taps.tap_size == 643


def test_poly_ext_matches_jax():
    from risc0_tpu.circuit.recursion import circuit as JC
    from risc0_tpu_torch.circuit.recursion import circuit as TC

    c, t = JC.load_circuit(), TC.load_circuit()
    rng = np.random.default_rng(3)
    pm = RF.encode_np(rng.integers(0, RF.P, 4, dtype=np.uint32))
    eval_u = RF.encode_np(rng.integers(0, RF.P, (643, 4), dtype=np.uint32))
    out = RF.encode_np(rng.integers(0, RF.P, 32, dtype=np.uint32))
    mix = RF.encode_np(rng.integers(0, RF.P, 20, dtype=np.uint32))
    want = c.poly_ext(pm, eval_u, out, mix)
    assert np.array_equal(t.poly_ext(pm, eval_u, out, mix), want)
    out[0] = (int(out[0]) + 1) % RF.P
    assert not np.array_equal(t.poly_ext(pm, eval_u, out, mix), want)


@pytest.mark.parametrize("chunk", [16, 64])
def test_range_eval_check_matches_jax_plan_oracle(chunk):
    from risc0_tpu.circuit.recursion.circuit import \
        load_prover_circuit as jload
    from risc0_tpu.circuit.recursion.prove import _RecPlanHal
    from risc0_tpu_torch.circuit.recursion.circuit import load_prover_circuit
    from risc0_tpu_torch.circuit.ir_range import RangePlanHal
    from risc0_tpu_torch.convert import to_numpy, to_torch

    po2 = 4
    domain = (1 << po2) * 4
    rng = np.random.default_rng(5)
    accum = rng.integers(0, F.P, (12, domain), dtype=np.uint32)
    code = rng.integers(0, F.P, (23, domain), dtype=np.uint32)
    data = rng.integers(0, F.P, (128, domain), dtype=np.uint32)
    mix_g = rng.integers(0, F.P, (20,), dtype=np.uint32)
    out_g = rng.integers(0, F.P, (32,), dtype=np.uint32)
    poly_mix = rng.integers(0, F.P, (4,), dtype=np.uint32)

    want = _RecPlanHal(jload()).eval_check(
        [accum, code, data], [mix_g, out_g], poly_mix, po2)
    hal = RangePlanHal(load_prover_circuit(), chunk=chunk)
    got = hal.eval_check([to_torch(g) for g in (accum, code, data)],
                         [mix_g, out_g], poly_mix, po2)
    assert np.array_equal(to_numpy(got), want)


# -- preflight, witgen, prove of a small program ------------------------------

def test_preflight_and_witgens_match_jax(asm):
    from risc0_tpu.circuit.recursion import prove as JP
    from risc0_tpu.circuit.recursion.preflight import \
        RecursionPreflight as JPreflight

    jprog, prog, inp = asm
    jpf, pf = JPreflight(inp), RecursionPreflight(inp)
    jpf.run(jprog.code)
    pf.run(prog.code)
    for key in ("wom", "iops", "cycles", "output"):
        assert getattr(pf, key) == getattr(jpf, key), key

    want = JP.witgen_recursion(jprog, jpf, rng=np.random.default_rng(1))
    got = TP.witgen_recursion(prog, pf, rng=np.random.default_rng(1))
    for key in ("ctrl", "data", "global", "iop_idx", "par_safe"):
        assert np.array_equal(got[key], want[key]), key
    mix = np.random.default_rng(2).integers(0, F.P, 20, dtype=np.uint32)
    assert np.array_equal(
        TP.accum_recursion(got, mix, rng=np.random.default_rng(4)),
        JP.accum_recursion(want, mix, rng=np.random.default_rng(4)))


def test_seal_is_the_jax_seal(asm_seal):
    seal, _out = asm_seal
    assert np.array_equal(np.asarray(seal, np.uint32), np.load(ASM_SEAL))


def test_control_id_is_jax_and_seal_verifies(asm, asm_seal):
    from risc0_tpu_torch.circuit.recursion.circuit import \
        verify_recursion_seal
    from risc0_tpu_torch.verify.verifier import \
        VerificationError as ZkpError

    jprog, prog, inp = asm
    cid = prog.control_id(device="cpu")
    assert np.array_equal(cid, jprog.control_id())
    seen = []

    def check(po2, root):
        seen.append(po2)
        if not np.array_equal(root, cid):
            raise ZkpError("control id mismatch")

    seal, _ = asm_seal
    out = verify_recursion_seal(seal, check)
    assert seen == [11]
    got = F.decode_np(np.asarray(out[:2], np.uint32))
    assert list(got) == [sum(v * v for v in inp) % F.P, 0]
    bad = np.array(seal)
    bad[100] ^= 1
    with pytest.raises(ZkpError):
        verify_recursion_seal(bad, check)


@pytest.mark.slow
def test_live_jax_seal_equals_the_fixture(asm):
    from risc0_tpu.circuit.recursion.prove import prove_program

    jprog, _prog, inp = asm
    seal, _ = prove_program(jprog, inp, rng=np.random.default_rng(9),
                            use_jit=False)
    assert np.array_equal(np.asarray(seal, np.uint32), np.load(ASM_SEAL))


# -- the lift predicate in the preflight --------------------------------------

def _lift_tape(root, seal):
    return [int(w) for w in np.asarray(root, np.uint32)] + \
        [int(w) for w in np.asarray(seal, np.uint32)]


def test_lift_preflight_on_a_real_seal():
    seal = np.load(SEGMENT_SEAL)
    _ids, root = own_control_ids()
    prog = load_own_program("lift_rv32im_14")
    pf = RecursionPreflight(_lift_tape(root, seal))
    pf.run(prog.code)  # raises on any in-VM assertion
    assert pf.output[:8] == [int(w) for w in root]
    # output() emits component 0 of each cell: the low short of each word
    assert pf.output[8:] == [int(w) & 0xFFFF
                             for w in decode_claim(seal).digest()]
    bad = seal.copy()
    bad[3] ^= 1
    with pytest.raises((ValueError, IndexError)):
        RecursionPreflight(_lift_tape(root, bad)).run(prog.code)


def test_decode_claim_matches_jax_and_the_frozen_digest():
    from risc0_tpu.circuit.rv32im.claim import decode_claim as jdecode

    seal = np.load(SEGMENT_SEAL)
    got, want = decode_claim(seal), jdecode(seal)
    assert np.array_equal(got.digest(), want.digest())
    assert got.exit_code.into_pair() == want.exit_code.into_pair()
    with open(os.path.join(DATA, "rv32im_seal_po2_14.claim_digest")) as f:
        assert got.digest().tobytes().hex() == f.read().strip()
    bad = seal.copy()
    bad[0] = 1
    with pytest.raises(ValueError):
        decode_claim(bad)


# -- control IDs ----------------------------------------------------------------

def test_merkle_group_matches_own_control_ids():
    from risc0_tpu.circuit.recursion.predicates import \
        own_control_ids as jids
    from risc0_tpu_torch.hash.suite import POSEIDON2
    from risc0_tpu_torch.zkvm.receipt import verify_control_inclusion

    ids, root = own_control_ids()
    want_ids, want_root = jids()
    assert sorted(ids) == sorted(want_ids)
    assert all(np.array_equal(ids[k], want_ids[k]) for k in ids)
    assert np.array_equal(root, want_root)
    grp = TP.MerkleGroup([ids[k] for k in sorted(ids)])
    assert np.array_equal(grp.calc_root(), root)
    for name in ("join", "lift_rv32im_14", "lift_rv32im_20", "union"):
        proof = grp.get_proof(ids[name])
        assert proof["index"] == sorted(ids).index(name)
        assert verify_control_inclusion(proof, ids[name], root, POSEIDON2)
        wrong = dict(proof, index=proof["index"] ^ 1)
        assert not verify_control_inclusion(wrong, ids[name], root,
                                            POSEIDON2)


def test_own_programs_load_as_the_jax_package_loads_them():
    from risc0_tpu.circuit.recursion.predicates import \
        load_own_program as jload
    from risc0_tpu.circuit.recursion.prove import load_keccak_lift as jkl

    for name in ("lift_rv32im_20", "join"):
        got, want = load_own_program(name), jload(name)
        assert got.po2 == want.po2 == 18
        assert np.array_equal(got.code, want.code)
    assert np.array_equal(TP.load_keccak_lift(14).code, jkl(14).code)


@pytest.mark.slow
def test_keccak_lift_control_id_is_the_official_digest():
    root = TP.load_keccak_lift(14).control_id(device="cpu")
    want = np.frombuffer(bytes.fromhex(
        "92631f2b8dc9431cb2abdc1e82ac2e30deaf086a36e51e4aa60ad0516bf5b748"),
        np.uint32)
    assert np.array_equal(root, want)


# -- golden succinct receipts ----------------------------------------------------

def _golden(name):
    """(receipt, ctx) of a golden fixture, its claim derived as in
    tests/test_golden.py."""
    seal = np.load(os.path.join(DATA, name + ".npy"))
    meta = np.load(os.path.join(DATA, name + ".meta.npz"))
    segment_seal = np.load(SEGMENT_SEAL)
    if name == "recursion_seal_lift14":
        claim = decode_claim(segment_seal)
    elif name == "union_seal_lift14x2":
        assumption = Assumption(decode_claim(segment_seal).digest(),
                                np.asarray(meta["control_root"],
                                           np.uint32)).digest()
        claim = MaybePruned.from_digest(
            UnionClaim(left=assumption, right=assumption).digest())
    else:
        with open(os.path.join(DATA, name + ".claim_digest")) as f:
            claim = MaybePruned.from_digest(
                np.frombuffer(bytes.fromhex(f.read().strip()), np.uint32))
    receipt = SuccinctReceipt(
        seal=seal, control_id=meta["control_id"], claim=claim,
        control_root=meta["control_root"],
        control_inclusion_proof={"index": int(meta["incl_index"]),
                                 "digests": meta["incl_digests"]})
    return receipt, VerifierContext(control_root=meta["control_root"])


GOLDEN = ["recursion_seal_lift14", "union_seal_lift14x2",
          "keccak_lift14_seal"]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_succinct_receipt_verifies(name):
    from risc0_tpu_torch.zkvm.recursion_driver import receipt_claim_digest

    receipt, ctx = _golden(name)
    receipt.verify_integrity(ctx)
    assert np.array_equal(receipt_claim_digest(receipt),
                          receipt.claim.digest())


@pytest.mark.parametrize("name", GOLDEN)
@pytest.mark.parametrize("fault", ["seal word", "claim", "inclusion index"])
def test_corrupted_golden_receipt_is_rejected(name, fault):
    receipt, ctx = _golden(name)
    if fault == "seal word":
        bad = np.array(receipt.seal)
        bad[40] ^= 1  # the code group's top Merkle layer
        receipt = dataclasses.replace(receipt, seal=bad)
    elif fault == "claim":
        d = np.array(receipt.claim.digest())
        d[0] ^= 1
        receipt = dataclasses.replace(receipt,
                                      claim=MaybePruned.from_digest(d))
    else:
        proof = receipt.control_inclusion_proof
        receipt = dataclasses.replace(receipt, control_inclusion_proof=dict(
            proof, index=proof["index"] ^ 1))
    with pytest.raises(VerificationError):
        receipt.verify_integrity(ctx)


def test_flipped_opening_word_is_rejected_by_the_stark():
    """A word in the FRI openings, past every cheap check."""
    receipt, ctx = _golden("recursion_seal_lift14")
    bad = np.array(receipt.seal)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(VerificationError, match="recursion seal invalid"):
        dataclasses.replace(receipt, seal=bad).verify_integrity(ctx)


# -- the suites by name --------------------------------------------------

def test_every_suite_is_served_by_name():
    """get_suite serves the reference's four suites by every name the JAX
    package accepts, and raises for an unknown one: a receipt's hashfn
    never gets another suite in its place."""
    from risc0_tpu_torch.hash.suite import (BLAKE2B, POSEIDON2, POSEIDON254,
                                            SHA256, get_suite)

    for names, suite in ((("poseidon2",), POSEIDON2),
                         (("sha256", "sha-256"), SHA256),
                         (("poseidon254", "poseidon_254"), POSEIDON254),
                         (("blake2b",), BLAKE2B)):
        for name in names:
            assert get_suite(name) is suite
    with pytest.raises(ValueError):
        get_suite("md5")
    # a Poseidon2 seal read as a Poseidon254 receipt is rejected
    receipt, ctx = _golden("recursion_seal_lift14")
    receipt = dataclasses.replace(receipt, hashfn="poseidon254")
    with pytest.raises(VerificationError):
        receipt.verify_integrity(VerifierContext(
            hashfn="poseidon254", control_root=ctx.control_root))


def test_session_claim_leaves_out_the_keccak_root():
    """A session whose guest assumed the union root of its pending keccak
    requests (sys_verify_integrity2) claims no assumption: the root's
    receipt resolves it at prove time.  tests/test_torch_composition.py
    holds the claims, tapes and resolve fold against the JAX package."""
    from risc0_tpu_torch.zkvm.claims import ExitCode
    from risc0_tpu_torch.zkvm.receipt import (keccak_root_claim,
                                              session_claim,
                                              session_segment_output)

    requests = [{"input": [[i] * 25]} for i in range(3)]
    root = keccak_root_claim(requests)
    zero = np.zeros(8, np.uint32)

    class Session:
        exit_code = ("Halted", 0)
        journal = b"j"
        pre_state = post_state = input_digest = zero
        pending_keccaks = requests
        assumptions_used = [(Assumption(root, zero), None)]

    claim = session_claim(Session())
    assert claim.exit_code == ExitCode("Halted", 0)
    assert claim.output.value.assumptions.value.items == []
    assert len(session_segment_output(
        Session()).value.assumptions.value.items) == 1


@pytest.mark.slow
def test_lift_on_the_cpu():
    """lift_rv32im_14 of the po2 14 segment seal, proved on the CPU."""
    from risc0_tpu_torch.zkvm.receipt import SegmentReceipt
    from risc0_tpu_torch.zkvm.recursion_driver import lift

    seal = np.load(SEGMENT_SEAL)
    sr = SegmentReceipt(seal=seal, index=0, hashfn="poseidon2",
                        claim=decode_claim(seal))
    receipt = lift(sr, rng=np.random.default_rng(1), device="cpu",
                   eval_chunk=1 << 13)
    _ids, root = own_control_ids()
    receipt.verify_integrity(VerifierContext(control_root=root))
    assert np.array_equal(receipt.claim.digest(),
                          decode_claim(seal).digest())
