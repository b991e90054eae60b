"""The port's hash suites on the CPU against the JAX package.

  * every suite's hash_pair, hash_elem_slice and Fiat-Shamir rng (the same
    draws after the same mixes) on the same seeded inputs;
  * the host Merkle trees of the SHA-256, Poseidon254 and Blake2b suites
    (hal.merkle_layers) of a (16, 2^10) matrix;
  * the reference's Poseidon254 test vectors and the digest_to_fr range;
  * the fib po2 6 seal under each of those three suites is the JAX
    package's word for word (tests/data/fib_seal_po2_6_<suite>.npy, made
    by scripts/gen_suite_seals.py; the live JAX proves take about a
    minute, so that comparison is marked slow), and the port's verifier
    takes it and rejects a flipped word.

Hashes and field arithmetic are exact, so every comparison is bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from risc0_tpu.hal import jnp_hal as rhal
from risc0_tpu.hash import suite as RS
from risc0_tpu_torch import field as F
from risc0_tpu_torch.convert import to_numpy
from risc0_tpu_torch.hal import torch_hal as hal
from risc0_tpu_torch.hash import poseidon254 as p254
from risc0_tpu_torch.hash import suite as TS

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SUITES = ("poseidon2", "sha256", "poseidon254", "blake2b")
HOST_SUITES = ("sha256", "poseidon254", "blake2b")


def _digests(rng, n):
    """n digests that every suite takes: Poseidon2 reads digest words as
    BabyBear elements and Poseidon254 a digest as a canonical BN254
    scalar, so the words stay below P and the top one below the BN254
    modulus's."""
    d = rng.integers(0, F.P, (n, 8), dtype=np.uint32)
    d[:, 7] &= 0x0FFFFFFF
    return d


def _elems(rng, n):
    return rng.integers(0, F.P, n, dtype=np.uint32)


@pytest.mark.parametrize("name", SUITES)
def test_hash_pair_and_elem_slice_match_jax(name):
    rng = np.random.default_rng(1)
    ours, theirs = TS.get_suite(name), RS.get_suite(name)
    assert ours.name == theirs.name
    for a, b in _digests(rng, 6).reshape(3, 2, 8):
        assert np.array_equal(ours.hash_pair(a, b), theirs.hash_pair(a, b))
    for n in (1, 5, 16, 23, 128):
        e = _elems(rng, n)
        assert np.array_equal(ours.hash_elem_slice(e),
                              theirs.hash_elem_slice(e))


@pytest.mark.parametrize("name", SUITES)
def test_rng_draws_match_jax(name):
    rng = np.random.default_rng(2)
    ours = TS.get_suite(name).new_rng()
    theirs = RS.get_suite(name).new_rng()
    for d in _digests(rng, 4):
        ours.mix(d)
        theirs.mix(d)
        for bits in (1, 7, 20, 27):
            assert ours.random_bits(bits) == theirs.random_bits(bits)
        assert ours.random_elem() == theirs.random_elem()
        assert np.array_equal(ours.random_ext_elem(),
                              theirs.random_ext_elem())


def test_every_suite_by_every_name():
    for name in ("poseidon2", "sha256", "sha-256", "poseidon254",
                 "poseidon_254", "blake2b"):
        assert TS.get_suite(name).name == RS.get_suite(name).name
    with pytest.raises(ValueError, match="md5"):
        TS.get_suite("md5")


@pytest.mark.parametrize("name", HOST_SUITES)
def test_host_merkle_layers_match_jax(name):
    m = np.random.default_rng(3).integers(0, F.P, (16, 1 << 10),
                                          dtype=np.uint32)
    got = hal.merkle_layers(torch.from_numpy(m.view(np.int32)),
                            TS.get_suite(name))
    want = rhal.merkle_layers(m, name)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert np.array_equal(to_numpy(g), np.asarray(w))


def test_poseidon254_reference_vectors():
    """reference p254_test_vectors (zkp/src/core/hash/poseidon_254/
    mod.rs:245-267): a hash, two pairs and an rng transcript."""
    inp = [F.s_encode(i) for i in range(1, 6)]
    iop = p254.Poseidon254Rng()
    d1 = p254.unpadded_hash(np.array(inp, np.uint32))
    d2 = p254.hash_pair(d1, d1)
    d3 = p254.hash_pair(d1, d2)
    iop.mix(d3)
    assert iop.random_bits(7) == 5
    assert F.s_decode(iop.random_elem()) == 328085114
    inp += [iop.random_elem() for _ in range(23)]
    iop.mix(p254.unpadded_hash(np.array(inp, np.uint32)))
    assert F.s_decode(iop.random_elem()) == 726238606


def test_poseidon254_digest_fr_range():
    for v in (0, 1, 0x1234_5678_9ABC_DEF0_1122_3344, p254.FR_MOD - 1):
        assert p254.digest_to_fr(p254.fr_to_digest(v)) == v
    over = np.frombuffer(p254.FR_MOD.to_bytes(32, "little"), np.uint32)
    for bad in (over, np.full(8, 0xFFFFFFFF, np.uint32)):
        with pytest.raises(ValueError, match="canonical"):
            p254.digest_to_fr(bad)
    assert np.array_equal(p254.fr_to_digest(p254.FR_MOD), np.zeros(8))


def test_poseidon254_native_bulk_matches_the_sponge():
    """The host C++ leaf and pair hashes against the Python sponge."""
    rng = np.random.default_rng(4)
    m = rng.integers(0, F.P, (23, 8), dtype=np.uint32)
    leaves = p254.hash_rows(m)
    for r in range(8):
        assert np.array_equal(leaves[r], p254.unpadded_hash(m[:, r]))
    pairs = p254.hash_pairs(leaves[0::2], leaves[1::2])
    for i in range(4):
        assert np.array_equal(pairs[i], p254.hash_pair(leaves[2 * i],
                                                       leaves[2 * i + 1]))


def _fixture(name):
    return np.load(os.path.join(DATA, f"fib_seal_po2_6_{name}.npy"))


@pytest.mark.parametrize("name", HOST_SUITES)
def test_fib_seal_equals_jax_and_verifies(name):
    from risc0_tpu_torch.circuit import fib
    from risc0_tpu_torch.verify.verifier import VerificationError

    suite = TS.get_suite(name)
    seal = fib.prove(po2=6, seed=0, device="cpu", suite=suite)
    assert np.array_equal(seal, _fixture(name))
    fib.verify(seal, device="cpu", suite=suite)
    bad = np.array(seal)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(VerificationError):
        fib.verify(bad, device="cpu", suite=suite)
    # a seal read under another suite does not verify
    with pytest.raises(VerificationError):
        fib.verify(seal, device="cpu", suite=TS.POSEIDON2)


@pytest.mark.slow
@pytest.mark.parametrize("name", HOST_SUITES)
def test_live_jax_fib_seal_equals_the_fixture(name):
    from risc0_tpu.circuit import fib as jfib

    seal = jfib.prove(po2=6, suite=RS.get_suite(name), seed=0)
    assert np.array_equal(np.asarray(seal, np.uint32), _fixture(name))
