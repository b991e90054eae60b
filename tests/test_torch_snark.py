"""The port's stark-to-snark path on the CPU against the JAX package.

  * recursion under Poseidon254: the po2 11 program of
    tests/test_torch_recursion.py proved with prove_program(...,
    suite=POSEIDON254) is the JAX package's seal word for word
    (tests/data/recursion_seal_asm_po2_11_p254.npy, made by
    scripts/gen_suite_seals.py; the live JAX prove takes minutes, so that
    comparison is marked slow), and its Poseidon254 control ID is JAX's;
  * identity_p254 hands prove_zkr the JAX package's program, control IDs,
    tape, claim and suite (prove_zkr replaced by a recorder in both, as in
    tests/test_torch_composition.py); the golden p254_seal_identity.npy
    verifies as a port SuccinctReceipt and a flipped word is rejected;
  * Groth16 (the cases of tests/test_groth16.py, test_groth16_prove.py and
    test_solidity_verifier.py): BN254, the pairing, the reference vectors,
    the verifier-parameters digest, seal_to_json equal to the JAX to_json
    string for string, the proof JSON and seal formats, the gadgets against
    the host functions, a small-circuit setup/prove/verify, the golden
    Groth16 receipt and the Solidity emitter;
  * shrink_wrap and ProverImpl's groth16 kind on stubs.
"""

import dataclasses
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.circuit.recursion import prove as TP
from risc0_tpu_torch.circuit.recursion.predicates import (
    identity_p254_control_id, own_control_ids)
from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
from risc0_tpu_torch.groth16 import bn254 as bn
from risc0_tpu_torch.groth16 import gadgets as G
from risc0_tpu_torch.groth16 import native as nat
from risc0_tpu_torch.groth16 import prove as GP
from risc0_tpu_torch.groth16 import solidity as S
from risc0_tpu_torch.groth16.r1cs import CS, ConstraintError, Q
from risc0_tpu_torch.groth16.verifier import (Verifier, VerifyingKey,
                                              proof_json_to_seal,
                                              verifying_key_from_json)
from risc0_tpu_torch.hash import poseidon254 as p254
from risc0_tpu_torch.hash.suite import POSEIDON254
from risc0_tpu_torch.zkvm.receipt import (Groth16Receipt,
                                          Groth16ReceiptVerifierParameters,
                                          SuccinctReceipt, VerificationError,
                                          VerifierContext)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CONTRACTS = os.path.join(REPO, "contracts")
ASM_P254 = os.path.join(DATA, "recursion_seal_asm_po2_11_p254.npy")
SEGMENT_SEAL = os.path.join(DATA, "rv32im_seal_po2_14.npy")


def _gen_script():
    spec = importlib.util.spec_from_file_location(
        "gen_suite_seals", os.path.join(REPO, "scripts", "gen_suite_seals.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def asm():
    jprog, inp = _gen_script().asm_program()
    return jprog, TP.Program(jprog.code.ravel(), jprog.po2), inp


# -- recursion under Poseidon254 ----------------------------------------------

def test_p254_recursion_seal_equals_jax_and_verifies(asm):
    from risc0_tpu_torch.circuit.recursion.circuit import \
        verify_recursion_seal
    from risc0_tpu_torch.verify.verifier import VerificationError as ZkpError

    jprog, prog, inp = asm
    seal, _ = TP.prove_program(prog, inp, rng=np.random.default_rng(9),
                               device="cpu", eval_chunk=1 << 11,
                               suite=POSEIDON254)
    assert np.array_equal(seal, np.load(ASM_P254))
    cid = prog.control_id(device="cpu", suite=POSEIDON254)
    assert np.array_equal(cid, jprog.control_id("poseidon254"))
    seen = []

    def check(po2, root):
        seen.append(po2)
        if not np.array_equal(root, cid):
            raise ZkpError("control id mismatch")

    out = verify_recursion_seal(seal, check, suite=POSEIDON254)
    assert seen == [11]
    assert list(F.decode_np(np.asarray(out[:2], np.uint32))) == \
        [sum(v * v for v in inp) % F.P, 0]
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(ZkpError):
        verify_recursion_seal(bad, check, suite=POSEIDON254)


@pytest.mark.slow
def test_live_jax_p254_seal_equals_the_fixture(asm):
    from risc0_tpu.circuit.recursion.prove import prove_program
    from risc0_tpu.hash.suite import POSEIDON254 as JP254

    jprog, _prog, inp = asm
    seal, _ = prove_program(jprog, inp, suite=JP254,
                            rng=np.random.default_rng(9), use_jit=False)
    assert np.array_equal(np.asarray(seal, np.uint32), np.load(ASM_P254))


def test_merkle_group_under_poseidon254_matches_jax():
    from risc0_tpu.circuit.recursion.prove import MerkleGroup as JGroup
    from risc0_tpu.hash.suite import POSEIDON254 as JP254

    pid = identity_p254_control_id()
    ours = TP.MerkleGroup([pid], POSEIDON254)
    theirs = JGroup([pid])
    assert np.array_equal(ours.calc_root(), theirs.calc_root(JP254))
    got, want = ours.get_proof(pid), theirs.get_proof(pid, JP254)
    assert got["index"] == want["index"] == 0
    assert np.array_equal(np.asarray(got["digests"]),
                          np.asarray(want["digests"]))


# -- identity_p254 --------------------------------------------------------------

def _lift14(pkg):
    """The golden lift of the po2 14 segment seal in `pkg`'s classes."""
    C = importlib.import_module(f"{pkg}.circuit.rv32im.claim")
    R = importlib.import_module(f"{pkg}.zkvm.receipt")
    meta = np.load(os.path.join(DATA, "recursion_seal_lift14.meta.npz"))
    return R.SuccinctReceipt(
        seal=np.load(os.path.join(DATA, "recursion_seal_lift14.npy")),
        control_id=meta["control_id"],
        claim=C.decode_claim(np.load(SEGMENT_SEAL)),
        control_root=meta["control_root"],
        control_inclusion_proof={"index": int(meta["incl_index"]),
                                 "digests": meta["incl_digests"]})


def test_identity_p254_tape_matches_jax(monkeypatch):
    """What identity_p254 hands prove_zkr, in both packages, word for
    word (a recursion seal depends on its witgen rng, which the JAX
    identity_p254 does not take)."""
    logs = {}
    for pkg in ("risc0_tpu", "risc0_tpu_torch"):
        drv = importlib.import_module(f"{pkg}.zkvm.recursion_driver")
        log = logs[pkg] = []

        def prove_zkr(program, control_id, allowed, tape, claim=None,
                      suite=None, _log=log, **kw):
            _log.append({
                "po2": program.po2, "code": program.code.tolist(),
                "control_id": [int(w) for w in control_id],
                "allowed": [[int(w) for w in leaf] for leaf in allowed],
                "tape": [int(w) for w in tape], "suite": suite.name,
                "claim": [int(w) for w in claim.digest()]})
            raise StopIteration

        monkeypatch.setattr(drv, "prove_zkr", prove_zkr)
        kw = {"device": "cpu"} if pkg == "risc0_tpu_torch" else {}
        with pytest.raises(StopIteration):
            drv.identity_p254(_lift14(pkg), **kw)
    got, want = logs["risc0_tpu_torch"], logs["risc0_tpu"]
    assert got == want and len(got) == 1
    assert got[0]["suite"] == "poseidon254"
    assert got[0]["allowed"] == [got[0]["control_id"]]
    assert got[0]["control_id"] == [int(w) for w in
                                    identity_p254_control_id()]


def test_identity_p254_takes_only_a_poseidon2_receipt():
    from risc0_tpu_torch.zkvm.recursion_driver import identity_p254

    receipt = dataclasses.replace(_lift14("risc0_tpu_torch"),
                                  hashfn="poseidon254")
    with pytest.raises(VerificationError, match="poseidon2 inner"):
        identity_p254(receipt, device="cpu")


def _golden_p254():
    seal = np.load(os.path.join(DATA, "p254_seal_identity.npy"))
    meta = np.load(os.path.join(DATA, "p254_seal_identity.meta.npz"))
    receipt = SuccinctReceipt(
        seal=seal, control_id=meta["control_id"],
        claim=decode_claim(np.load(SEGMENT_SEAL)),
        control_root=meta["control_root"],
        control_inclusion_proof={"index": int(meta["incl_index"]),
                                 "digests": meta["incl_digests"]},
        hashfn="poseidon254")
    ctx = VerifierContext(hashfn="poseidon254",
                          control_root=receipt.control_root,
                          inner_control_root=own_control_ids()[1])
    return receipt, ctx


def test_golden_p254_receipt_verifies_and_a_flip_is_rejected():
    """The p254 seal's output root is the inner Poseidon2 allowed root
    (reference receipt/succinct.rs:182), its params root the singleton
    identity_p254 set."""
    receipt, ctx = _golden_p254()
    assert np.array_equal(receipt.control_id, identity_p254_control_id())
    assert np.array_equal(
        receipt.control_root,
        TP.MerkleGroup([receipt.control_id], POSEIDON254).calc_root())
    receipt.verify_integrity(ctx)
    bad = np.array(receipt.seal)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(VerificationError, match="recursion seal invalid"):
        dataclasses.replace(receipt, seal=bad).verify_integrity(ctx)
    with pytest.raises(VerificationError, match="hashfn"):
        receipt.verify_integrity(VerifierContext(
            control_root=ctx.control_root,
            inner_control_root=ctx.inner_control_root))


# -- Groth16: BN254, the verifier, the formats -------------------------------

def test_generators_on_curve():
    assert bn.g1_is_on_curve(bn.G1_GEN)
    assert bn.g2_is_on_curve(bn.G2_GEN)
    assert bn.g1_mul(bn.G1_GEN, bn.R) is None


def test_pairing_bilinearity():
    e1 = bn.pairing(bn.g1_mul(bn.G1_GEN, 2), bn.G2_GEN)
    e2 = bn.pairing(bn.G1_GEN, bn.G2_GEN)
    assert e1 == bn.f12_mul(e2, e2)
    assert e1 != bn.F12_ONE
    assert bn.multi_pairing_is_one(
        [(bn.G1_GEN, bn.G2_GEN), (bn.g1_neg(bn.G1_GEN), bn.G2_GEN)])


def _reference_vectors():
    d = os.path.join(DATA, "groth16")
    return tuple(json.load(open(os.path.join(d, f + ".json")))
                 for f in ("proof", "public", "verification_key"))


def test_groth16_reference_vectors():
    """The reference's proof/vk/public triple (risc0/groth16/tests/
    verify.rs) verifies; a changed public input does not."""
    proof, public, vk = _reference_vectors()
    assert Verifier.from_json(proof, public, vk).verify()
    assert not Verifier.from_json(proof, [str(int(public[0]) + 1)],
                                  vk).verify()


def test_proof_json_to_seal_roundtrip():
    proof, public, vk_json = _reference_vectors()
    seal = proof_json_to_seal(proof)
    assert len(seal) == 256
    via_json = Verifier.from_json(proof, public, vk_json)
    w = [int.from_bytes(seal[32 * i: 32 * i + 32], "big") for i in range(8)]
    a, b, c = (w[0], w[1]), ((w[3], w[2]), (w[5], w[4])), (w[6], w[7])
    assert (a, b, c) == (via_json.a, via_json.b, via_json.c)
    assert Verifier(a, b, c, [int(x) for x in public],
                    verifying_key_from_json(vk_json)).verify()
    with pytest.raises(ValueError, match="seal length"):
        Verifier.from_seal(seal[:-1], np.zeros(8), np.zeros(8), np.zeros(8))


def test_verifier_parameters_digest_matches_reference():
    """reference receipt/groth16.rs:200-205: the published parameters
    digest of the published control root and BN254 control ID."""
    def digest(hexstr):
        return np.frombuffer(bytes.fromhex(hexstr), np.uint32).copy()

    params = Groth16ReceiptVerifierParameters(
        control_root=digest("3b304d1098ad401d3a04bc11976f476633a71b482b7851"
                            "189663ca61209abe45"),
        bn254_control_id=digest("c07a65145c3cb48b6101962ea607a4dd93c753bb"
                                "26975cb47feb00d3666e4404"))
    assert params.digest().tobytes().hex() == (
        "3880c9eb6bf2f1a7824608786aff4ed0b018e8ea18b7de6df0b5110c1915b65f")


@pytest.fixture(scope="module")
def golden_witness():
    """(seal types, witness JSON) of the golden p254 seal in the port: a
    replay of the verifier each, so made once for the module."""
    from risc0_tpu_torch.groth16.seal_to_json import derive_seal_types, to_json

    seal = np.load(os.path.join(DATA, "p254_seal_identity.npy"))
    types = derive_seal_types(seal)
    return types, to_json(seal, types=types)


def test_seal_to_json_equals_jax(golden_witness):
    """seal_to_json of the golden p254 seal (the types derived by
    replaying the verifier), string for string."""
    from risc0_tpu.groth16.seal_to_json import to_json as jax_to_json
    from risc0_tpu_torch.groth16.seal_to_json import to_json

    seal = np.load(os.path.join(DATA, "p254_seal_identity.npy"))
    types, got = golden_witness
    assert sum(1 if t == "fp" else 8 for t in types) == len(seal)
    assert got == jax_to_json(seal)
    iop = json.loads(got)["iop"]
    assert len(iop) == len(types)
    mini = np.array([F.s_encode(7)] + [1, 0, 0, 0, 0, 0, 0, 0], np.uint32)
    assert json.loads(to_json(mini, types=["fp", "digest"]))["iop"] == \
        ["7", "1"]
    with pytest.raises(ValueError, match="length mismatch"):
        to_json(mini[:-1], types=["fp", "digest"])


def _golden_groth16():
    z = np.load(os.path.join(DATA, "groth16_receipt_golden.npz"))
    vk = VerifyingKey(
        alpha_g1=nat.g1_from_arr(z["vk_alpha_g1"])[0],
        beta_g2=nat.g2_from_arr(z["vk_beta_g2"])[0],
        gamma_g2=nat.g2_from_arr(z["vk_gamma_g2"])[0],
        delta_g2=nat.g2_from_arr(z["vk_delta_g2"])[0],
        ic=nat.g1_from_arr(z["vk_ic"]))
    return z, vk


def _golden_params(vk):
    params = Groth16ReceiptVerifierParameters.default()
    params.verifying_key = vk
    return params


def test_golden_groth16_receipt_verifies():
    """The frozen Groth16 receipt of the real identity_p254 seal, against
    its embedded verifying key; a changed public input is rejected."""
    z, vk = _golden_groth16()
    params = _golden_params(vk)
    assert np.array_equal(params.digest(), z["verifier_parameters"])
    claim = decode_claim(np.load(SEGMENT_SEAL))
    assert np.array_equal(claim.digest(), z["claim_digest"])
    receipt = Groth16Receipt(seal=z["seal"].tobytes(), claim=claim,
                             verifier_parameters=z["verifier_parameters"])
    receipt.verify_integrity(VerifierContext(groth16_params=params))
    other = Groth16ReceiptVerifierParameters(
        control_root=params.control_root ^ np.uint32(1),
        bn254_control_id=params.bn254_control_id, verifying_key=vk)
    with pytest.raises(VerificationError):
        receipt.verify_integrity(VerifierContext(groth16_params=other))
    with pytest.raises(VerificationError, match="parameters"):
        receipt.verify_integrity(VerifierContext())


# -- Groth16: the prover's host core and gadgets -----------------------------

def _verifier(proof, vk, publics=None):
    return Verifier(
        (int(proof["pi_a"][0]), int(proof["pi_a"][1])),
        ((int(proof["pi_b"][0][0]), int(proof["pi_b"][0][1])),
         (int(proof["pi_b"][1][0]), int(proof["pi_b"][1][1]))),
        (int(proof["pi_c"][0]), int(proof["pi_c"][1])),
        publics if publics is not None
        else [int(x) for x in proof["public"]], vk)


def test_native_bn254_ops():
    rng = random.Random(1)
    ks = [rng.randrange(bn.R) for _ in range(30)] + [0]
    outs = nat.g1_fixed_msm(bn.G1_GEN, ks)
    assert nat.g1_from_arr(outs) == [
        bn.g1_mul(bn.G1_GEN, k) if k else None for k in ks]
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, 999)) for _ in range(16)]
    ref = None
    for p, k in zip(pts, ks):
        ref = bn.g1_add(ref, bn.g1_mul(p, k))
    assert nat.g1_msm(nat.g1_arr(pts), ks[:16]) == ref
    out = np.zeros(16, np.uint64)
    nat.lib().bn254_g2_mul(nat.g2_arr([bn.G2_GEN])[0], nat.limbs(bn.R), out)
    assert nat.g2_from_arr(out)[0] is None


def test_native_fr_ntt_roundtrip():
    rng = random.Random(2)
    n = 64
    root = pow(5, (Q - 1) // n, Q)
    vals = [rng.randrange(Q) for _ in range(n)]
    a = nat.fr_arr(vals)
    nat.fr_ntt(a, root)
    assert nat.fr_list(a[5:6])[0] == \
        sum(vals[i] * pow(root, i * 5, Q) for i in range(n)) % Q
    nat.fr_ntt(a, root, inverse=True)
    assert nat.fr_list(a) == vals


def test_poseidon254_gadget_matches_host():
    rng = random.Random(3)
    cs = CS(check=True)
    vals = [rng.randrange(Q) for _ in range(3)]
    out = G.p254_permute(cs, [cs.witness(v) for v in vals])
    assert [o.val for o in out] == p254.permute(vals)
    elems = [rng.randrange(F.P) for _ in range(23)]
    got = G.p254_hash_slice(cs, [G.bb_input(cs, v) for v in elems])
    assert got.val == p254.digest_to_fr(p254.unpadded_hash(
        np.array([F.s_encode(v) for v in elems], np.uint32)))


def test_rng_gadget_matches_host():
    rng = random.Random(4)
    cs = CS(check=True)
    g = G.RngGadget(cs)
    h = p254.Poseidon254Rng()
    for _ in range(2):
        d = rng.randrange(Q)
        g.mix(cs.witness(d))
        h.mix(p254.fr_to_digest(d))
    bits = g.random_bits(20)
    assert sum(b.val << i for i, b in enumerate(bits)) == h.random_bits(20)
    assert g.random_elem().val == F.s_decode(h.random_elem())
    assert [x.val for x in g.random_ext_elem()] == \
        [int(v) for v in F.decode_np(h.random_ext_elem())]


def test_babybear_ext_gadgets_match_host():
    rng = random.Random(5)
    cs = CS(check=True)
    a = [rng.randrange(F.P) for _ in range(4)]
    b = [rng.randrange(F.P) for _ in range(4)]
    bbb = [G.bb_input(cs, v) for v in b]
    acc = G.ext_mul(cs, [G.bb_input(cs, v) for v in a], bbb)
    bm = F.encode_np(np.array(b, np.uint32))
    ref = F.ext_mul_np(F.encode_np(np.array(a, np.uint32)), bm)
    for _ in range(6):  # lazy reduction chains
        acc = G.ext_mul(cs, acc, bbb)
        ref = F.ext_mul_np(ref, bm)
    assert [x.val for x in acc] == [int(v) for v in F.decode_np(ref)]
    inv = G.ext_inv(cs, acc)
    assert [x.val for x in inv] == \
        [int(v) for v in F.decode_np(F.ext_inv_np(ref))]
    with pytest.raises(ConstraintError):
        G.bb_assert_eq(cs, acc[0], G.bb_const(cs, (acc[0].val + 1) % F.P))


def _small_circuit(x_val, y_val):
    """The small R1CS of tests/test_groth16_prove.py: one public output
    (x*y + x + 7)^2 + y."""
    cs = CS(check=True)
    pub = cs.alloc_public()
    x = cs.witness(x_val)
    y = cs.witness(y_val)
    out = (x * y + x + 7) * (x * y + x + 7) + y
    cs.bind_public(pub, out)
    cs.finalize()
    return cs


def test_groth16_roundtrip_small_circuit():
    cs = _small_circuit(3, 4)
    pk, vk = GP.setup(cs)
    proof = GP.prove(pk, cs)
    assert int(proof["public"][0]) == (3 * 4 + 3 + 7) ** 2 + 4
    assert _verifier(proof, vk).verify()
    proof2 = GP.prove(pk, _small_circuit(10, 20))
    assert _verifier(proof2, vk).verify()
    assert not _verifier(proof2, vk, [int(proof2["public"][0]) + 1]).verify()
    cs3 = _small_circuit(3, 4)
    cs3.assert_zero(cs3.zero())  # another structure
    with pytest.raises(ValueError, match="does not match"):
        GP.prove(pk, cs3)


# -- Solidity --------------------------------------------------------------

def test_generated_vk_constants_roundtrip():
    _z, vk = _golden_groth16()
    back = S.parse_vk_from_sol(S.generate_groth16_verifier(vk))
    assert (back.alpha_g1, back.beta_g2, back.gamma_g2, back.delta_g2,
            back.ic) == (vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2,
                         list(vk.ic))


def test_committed_contracts_in_sync_with_golden():
    """contracts/*.sol are what the port's emitter makes of the golden
    verifying key and parameters (scripts/gen_solidity_verifier.py)."""
    from risc0_tpu_torch.groth16.wrap import verifier_parameters

    _z, vk = _golden_groth16()
    params = verifier_parameters(vk)
    want1 = S.generate_groth16_verifier(vk)
    want2 = S.generate_risczero_verifier(
        own_control_ids()[1], identity_p254_control_id(), params.digest())
    assert open(os.path.join(CONTRACTS, "Groth16Verifier.sol")).read() \
        == want1
    assert open(os.path.join(
        CONTRACTS, "RiscZeroGroth16Verifier.sol")).read() == want2


def test_calldata_roundtrip_and_selector_check():
    z, vk = _golden_groth16()
    params = _golden_params(vk)
    seal = bytes(z["seal"].tobytes())
    calldata = S.seal_to_calldata(seal, params.digest())
    assert len(calldata) == 260
    sel, a, b, c = S.decode_calldata(calldata, params.digest())
    assert sel == S.selector_from_params(params.digest())
    w = [int.from_bytes(seal[32 * i: 32 * i + 32], "big") for i in range(8)]
    assert a == (w[0], w[1]) and c == (w[6], w[7])
    assert b == ((w[2], w[3]), (w[4], w[5]))
    with pytest.raises(ValueError, match="selector"):
        S.decode_calldata(b"\x00" * 4 + seal, params.digest())
    receipt = Groth16Receipt(seal=seal, claim=None,
                             verifier_parameters=params.digest())
    assert receipt.seal_calldata() == calldata


def test_sol_claim_hashing_matches_zkvm_claims():
    from risc0_tpu_torch.zkvm.claims import receipt_claim_ok

    rng = np.random.default_rng(3)
    for _ in range(4):
        image_id = rng.integers(0, 2**32, 8, dtype=np.uint32)
        journal = rng.integers(0, 2**32, 8, dtype=np.uint32)
        want = np.asarray(receipt_claim_ok(image_id, journal).digest(),
                          np.uint32).tobytes()
        assert S.sol_ok_claim_digest(image_id.tobytes(),
                                     journal.tobytes()) == want


def test_parsed_sol_vk_verifies_golden_seal():
    z, _vk = _golden_groth16()
    vk = S.parse_vk_from_sol(
        open(os.path.join(CONTRACTS, "Groth16Verifier.sol")).read())
    v = Verifier.from_seal(bytes(z["seal"].tobytes()), own_control_ids()[1],
                           z["claim_digest"], identity_p254_control_id(),
                           vk=vk)
    assert v.verify()


# -- shrink_wrap and the groth16 receipt kind ---------------------------------

def _seal_as_proof_json(seal: bytes) -> dict:
    """A 256-byte seal as the snarkjs proof JSON an external prover
    prints (the inverse of proof_json_to_seal)."""
    w = [str(int.from_bytes(seal[32 * i: 32 * i + 32], "big"))
         for i in range(8)]
    return {"pi_a": [w[0], w[1], "1"], "pi_b": [[w[3], w[2]], [w[5], w[4]],
                                               ["1", "0"]],
            "pi_c": [w[6], w[7], "1"], "protocol": "groth16"}


@pytest.fixture
def wrap_stubs(monkeypatch, golden_witness):
    """identity_p254 returns the golden p254 receipt (whose witness JSON
    test_seal_to_json_equals_jax holds to the JAX package's), and the
    default Groth16 parameters carry the golden receipt's verifying key
    (the key an external prover targets), so the golden Groth16 seal
    stands for the external prover's answer.  Returns (prover options
    kw, seen witness JSON)."""
    from risc0_tpu_torch.groth16 import seal_to_json
    from risc0_tpu_torch.zkvm import receipt as R
    from risc0_tpu_torch.zkvm import recursion_driver as drv

    p254_seal = _golden_p254()[0].seal

    def to_json(seal):
        assert np.array_equal(seal, p254_seal)
        return golden_witness[1]

    monkeypatch.setattr(seal_to_json, "to_json", to_json)

    z, vk = _golden_groth16()
    default = R.Groth16ReceiptVerifierParameters.default
    monkeypatch.setattr(R.Groth16ReceiptVerifierParameters, "default",
                        staticmethod(lambda: dataclasses.replace(
                            default(), verifying_key=vk)))
    monkeypatch.setattr(drv, "identity_p254",
                        lambda inner, device="cuda", **kw: _golden_p254()[0])
    seen = []

    def snark_prover(witness_json):
        seen.append(witness_json)
        return {"proof": _seal_as_proof_json(z["seal"].tobytes())}

    return {"snark_prover": snark_prover}, seen


@pytest.mark.parametrize("via", ["hook", "RISC0_SNARK_PROVER"])
def test_shrink_wrap_builds_a_groth16_receipt(wrap_stubs, monkeypatch,
                                              tmp_path, via):
    """The external prover as a callable (a snarkjs proof JSON back) or as
    the shell command RISC0_SNARK_PROVER names ({"seal": hex} on stdout;
    a failing command raises)."""
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    opts, seen = wrap_stubs
    if via != "hook":
        z, _vk = _golden_groth16()
        answer = tmp_path / "answer.json"
        answer.write_text(json.dumps({"seal": z["seal"].tobytes().hex()}))
        monkeypatch.setenv("RISC0_SNARK_PROVER",
                           f"tee {tmp_path / 'witness.json'} >/dev/null; "
                           f"cat {answer}")
        opts = {}
    prover = ProverImpl(ProverOpts(receipt_kind="groth16", **opts),
                        device="cpu")
    g = prover.shrink_wrap(_lift14("risc0_tpu_torch"))
    assert isinstance(g, Groth16Receipt)
    g.verify_integrity(VerifierContext())
    assert np.array_equal(g.claim.digest(),
                          decode_claim(np.load(SEGMENT_SEAL)).digest())
    # the external prover was handed the p254 seal's witness JSON
    (witness,) = seen or [(tmp_path / "witness.json").read_text()]
    iop = json.loads(witness)["iop"]
    seal = _golden_p254()[0].seal
    assert iop[0] == str(F.s_decode(int(seal[0])))
    assert len(iop) < len(seal)
    if via != "hook":
        monkeypatch.setenv("RISC0_SNARK_PROVER", "exit 3")
        with pytest.raises(RuntimeError, match="snark prover failed"):
            prover.shrink_wrap(_lift14("risc0_tpu_torch"))


def test_prover_impl_groth16_kind_on_stubs(wrap_stubs):
    """ProverImpl(groth16).prove_session: the compress stubbed with the
    golden lift, identity_p254 and the Groth16 prover as above; the
    receipt is a verified Groth16 one of the compressed claim."""
    from risc0_tpu_torch.zkvm.prover import ProverImpl, ProverOpts

    opts, _seen = wrap_stubs

    class Session:
        segments = []
        exit_code = ("Halted", 0)
        journal = b""
        assumptions_used = []
        pending_keccaks = []

    prover = ProverImpl(ProverOpts(receipt_kind="groth16", **opts),
                        device="cpu")
    prover.compress_composite = lambda composite: _lift14("risc0_tpu_torch")
    info = prover.prove_session(Session())
    assert info.receipt.inner.kind == "groth16"
    assert np.array_equal(info.receipt.claim().digest(),
                          decode_claim(np.load(SEGMENT_SEAL)).digest())
    info.receipt.verify_integrity()


def test_torch_gen_solidity_verifier_writes_the_committed_contracts(
        tmp_path):
    """scripts/torch_gen_solidity_verifier.py, the port's counterpart of
    scripts/gen_solidity_verifier.py, regenerates contracts/*.sol byte
    for byte from the golden receipt's key."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "scripts", "torch_gen_solidity_verifier.py"),
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ("Groth16Verifier.sol", "RiscZeroGroth16Verifier.sol"):
        with open(os.path.join(REPO, "contracts", name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
