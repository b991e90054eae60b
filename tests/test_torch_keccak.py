"""The port's keccak circuit on the CPU against the JAX package.

  * the circuit's tap set and constraint IR are the JAX package's;
  * the host witgen gives the same data and globals at po2 14;
  * compute_keccak_digest and keccak_digest_from_globals agree with the
    JAX package's and with each other;
  * the range-plan eval_check of the keccak IR (the prover's, on torch)
    gives the JAX package's numpy plan words at po2 4, at two chunks;
  * tests/data/keccak_seal_po2_14.npy, the JAX package's po2 14 seal of
    the golden keccak lift's inputs, verifies in the port, its globals give
    the golden claim digest, and a flipped word is rejected.  The port's
    seal of those inputs on the CPU equals it word for word, and so does a
    live JAX prove; both take minutes and are marked slow.

Field arithmetic is exact, so every comparison is bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from risc0_tpu import field as RF

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEAL = os.path.join(DATA, "keccak_seal_po2_14.npy")


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
            for _ in range(n)]


def _fixture_inputs():
    """scripts/gen_keccak_seal.py inputs(): the golden keccak lift's."""
    return _inputs(2, seed=14)


# -- circuit -----------------------------------------------------------------

def test_circuit_matches_jax():
    from risc0_tpu.circuit.keccak import circuit as JC
    from risc0_tpu_torch.circuit.keccak import circuit as TC

    want, got = JC.load_circuit(), TC.load_circuit()
    assert (got.taps.tap_size, got.taps.reg_count, len(got.opcode)) == \
        (3631, want.taps.reg_count, 90456)
    assert [dataclasses.astuple(r) for r in got.taps.regs] == \
        [dataclasses.astuple(r) for r in want.taps.regs]
    assert got.taps.combos == want.taps.combos
    for name in ("opcode", "operands", "mix_powers"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for name in ("n_f", "n_e", "fscr_size", "escr_size", "ret",
                 "CIRCUIT_INFO", "OUTPUT_SIZE", "MIX_SIZE"):
        assert getattr(got, name) == getattr(want, name), name


def test_constants_match_jax():
    import risc0_tpu.circuit.keccak as J
    import risc0_tpu_torch.circuit.keccak as T

    assert T.KECCAK_DEFAULT_PO2 == J.KECCAK_DEFAULT_PO2 == 17
    assert T.KECCAK_PO2_RANGE == J.KECCAK_PO2_RANGE
    assert T.KECCAK_PERMUTE_CYCLES == J.KECCAK_PERMUTE_CYCLES


# -- witgen and digests -------------------------------------------------------

@pytest.fixture(scope="module")
def witgen3():
    from risc0_tpu.circuit.keccak.witgen import witgen_keccak as jw
    from risc0_tpu_torch.circuit.keccak.witgen import witgen_keccak as tw

    return jw(_inputs(3), 14), tw(_inputs(3), 14)


def test_witgen_matches_jax(witgen3):
    want, got = witgen3
    assert got["data"].shape == (1096, 1 << 14)
    assert np.array_equal(got["data"], want["data"])
    assert np.array_equal(got["global"], want["global"])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_compute_keccak_digest_matches_jax(n):
    from risc0_tpu.circuit.keccak import compute_keccak_digest as jd
    from risc0_tpu_torch.circuit.keccak import compute_keccak_digest as td

    inputs = _inputs(n, seed=11 + n)
    assert np.array_equal(td(inputs), jd(inputs))


def test_digest_from_globals_matches_jax(witgen3):
    from risc0_tpu.circuit.keccak.verify import \
        keccak_digest_from_globals as jdg
    from risc0_tpu_torch.circuit.keccak import compute_keccak_digest
    from risc0_tpu_torch.circuit.keccak.verify import \
        keccak_digest_from_globals as tdg

    _want, got = witgen3
    glob = got["global"]
    assert np.array_equal(tdg(glob), jdg(glob))
    assert np.array_equal(tdg(glob), compute_keccak_digest(_inputs(3)))
    mont = RF.encode_np(glob)
    assert np.array_equal(tdg(mont, montgomery=True),
                          jdg(mont, montgomery=True))


# -- eval_check ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_eval_check_matches_jax_plan(chunk):
    """RangePlanHal (torch) against the JAX package's _PlanHal (numpy
    ir_exec plan) on random Montgomery groups over the po2 4 domain."""
    from risc0_tpu.circuit.keccak import circuit as JC
    from risc0_tpu.circuit.keccak.prove import _PlanHal
    from risc0_tpu_torch.circuit.ir_range import RangePlanHal
    from risc0_tpu_torch.circuit.keccak import circuit as TC
    from risc0_tpu_torch.convert import to_numpy, to_torch

    po2, domain = 4, 64
    rng = np.random.default_rng(40 + chunk)
    groups = [RF.encode_np(rng.integers(0, RF.P, (cols, domain),
                                        dtype=np.uint32))
              for cols in (1, 1, 1096)]  # accum, code, data
    mix = RF.encode_np(rng.integers(0, RF.P, 4, dtype=np.uint32))
    out = RF.encode_np(rng.integers(0, RF.P, 17, dtype=np.uint32))
    pm = RF.encode_np(rng.integers(0, RF.P, 4, dtype=np.uint32))
    want = _PlanHal(JC.load_circuit()).eval_check(groups, [mix, out], pm, po2)
    got = RangePlanHal(TC.load_circuit(), chunk=chunk).eval_check(
        [to_torch(g) for g in groups], [mix, out], pm, po2)
    assert np.array_equal(to_numpy(got), np.asarray(want, np.uint32))


# -- the seal -----------------------------------------------------------------

@pytest.mark.slow
def test_seal_is_the_jax_seal():
    """The port's po2 14 seal on the CPU (about 4 min with 2 torch
    threads; its run on the card is tests/test_torch_cuda.py's) is the
    fixture word for word."""
    from risc0_tpu_torch.circuit.keccak.prove import prove_keccak

    seal = prove_keccak(_fixture_inputs(), 14, device="cpu",
                        eval_chunk=1 << 12)
    assert np.array_equal(seal, np.load(SEAL))


def test_seal_verifies_with_the_golden_claim():
    from risc0_tpu_torch.circuit.keccak.verify import (
        keccak_digest_from_globals, verify_keccak_seal)

    out = verify_keccak_seal(np.load(SEAL))
    with open(os.path.join(DATA, "keccak_lift14_seal.claim_digest")) as f:
        want = np.frombuffer(bytes.fromhex(f.read().strip()), np.uint32)
    assert np.array_equal(keccak_digest_from_globals(out, montgomery=True),
                          want)


@pytest.mark.parametrize("where", ["global", "opening"])
def test_flipped_seal_word_is_rejected(where):
    from risc0_tpu_torch.circuit.keccak.verify import verify_keccak_seal
    from risc0_tpu_torch.verify.verifier import VerificationError

    bad = np.load(SEAL)
    bad[3 if where == "global" else len(bad) // 2] ^= 1
    with pytest.raises(VerificationError):
        verify_keccak_seal(bad)


@pytest.mark.slow
def test_fixture_is_the_live_jax_seal():
    """Regenerate the fixture with the JAX package (about 49 min)."""
    from risc0_tpu.circuit.keccak.prove import prove_keccak

    seal = prove_keccak(_fixture_inputs(), 14)
    assert np.array_equal(np.asarray(seal, np.uint32), np.load(SEAL))
