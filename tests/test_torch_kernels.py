"""The plain torch versions of the four CUDA kernels (the CPU path of their
wrappers) against the JAX package on the same numpy inputs: the Pallas NTT
kernels in interpret mode and core/ntt, the Poseidon2 hash_rows/hash_pairs
(jnp path on the CPU) and permute_np.  Field arithmetic is exact, so
every comparison is bit for bit.  The kernels themselves are compared with
these plain versions on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu.core import ntt as rntt
from risc0_tpu.hal.pallas import ntt as pntt
from risc0_tpu.hash import poseidon2 as rp2
from risc0_tpu_torch.convert import to_numpy, to_torch
from risc0_tpu_torch.core import ntt
from risc0_tpu_torch.hal.cuda import ntt as kntt
from risc0_tpu_torch.hal.cuda import poseidon2 as kp2
from risc0_tpu_torch.hash import poseidon2 as p2

torch.set_num_threads(2)


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, RF.P, shape,
                                                dtype=np.uint32)


# n_bits 12 runs the two-pass Pallas path (local block 2^7); 6 is at or
# below its local block, where Pallas falls back to core/ntt
@pytest.mark.parametrize("batch,n_bits", [(3, 12), (2, 6)])
def test_evaluate_matches_pallas(batch, n_bits):
    x = _rand(n_bits, (batch, 1 << n_bits))
    want = np.asarray(pntt.evaluate_ntt(jnp.asarray(x), interpret=True))
    got = to_numpy(kntt.evaluate_ntt(to_torch(x)))
    assert np.array_equal(got, want)


def test_lde_matches_pallas_and_core():
    # the commit LDE: expand 4x, then skip the bottom 2 stages
    coeffs = _rand(1, (3, 1 << 10))
    expanded = np.asarray(rntt.expand(jnp.asarray(coeffs), 2))
    want = np.asarray(pntt.evaluate_ntt(jnp.asarray(expanded), 2,
                                        interpret=True))
    assert np.array_equal(want, rntt.evaluate_ntt_np(expanded, 2))
    got = to_numpy(kntt.evaluate_ntt(ntt.expand(to_torch(coeffs), 2), 2))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batch,n_bits", [(3, 12), (4, 6)])
def test_interpolate_matches_pallas(batch, n_bits):
    x = _rand(n_bits + 100, (batch, 1 << n_bits))
    want = np.asarray(pntt.interpolate_ntt(jnp.asarray(x), interpret=True))
    got = to_numpy(kntt.interpolate_ntt(to_torch(x)))
    assert np.array_equal(got, want)


def test_ntt_roundtrip_plain():
    x = _rand(2, (2, 1 << 9))
    back = kntt.evaluate_ntt(kntt.interpolate_ntt(to_torch(x)))
    assert np.array_equal(to_numpy(back), x)


def test_permute_matches_reference():
    s = _rand(3, (40, 24))
    s[0] = 0
    s[1] = RF.P - 1
    want = rp2.permute_np(s)
    assert np.array_equal(p2.permute_np(s), want)
    assert np.array_equal(to_numpy(p2.permute(to_torch(s))), want)


def test_permute_vector():
    # the encoded words 0..23, as in tests/test_hash.py
    out = p2.permute_np(RF.encode_np(np.arange(24, dtype=np.uint32)))
    assert np.array_equal(out, rp2.permute_np(
        RF.encode_np(np.arange(24, dtype=np.uint32))))


# cols 0 (one permutation of zeros), 16 (exact chunks), 211 = 13*16 + 3
# (the data group), 1 (the code group); rows 1 (the final-FRI and
# long-sponge digests)
@pytest.mark.parametrize("cols,rows", [(0, 4), (1, 8), (16, 8), (211, 8),
                                       (37, 1), (1024, 1)])
def test_hash_rows_matches_reference(cols, rows):
    m = _rand(cols * 7 + rows, (cols, rows))
    want = np.asarray(rp2.hash_rows(jnp.asarray(m)))
    got = to_numpy(kp2.hash_rows(to_torch(m)))
    assert np.array_equal(got, want)
    for r in range(rows):
        assert np.array_equal(got[r], p2.unpadded_hash_np(m[:, r]))


@pytest.mark.parametrize("n", [1, 5, 64])
def test_hash_pairs_matches_reference(n):
    layer = _rand(n, (2 * n, 8))
    want = np.asarray(rp2.hash_pairs(jnp.asarray(layer[0::2]),
                                     jnp.asarray(layer[1::2])))
    t = to_torch(layer)
    got = to_numpy(kp2.hash_pairs(t[0::2], t[1::2]))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], p2.hash_pair_np(layer[0], layer[1]))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 600])
def test_unpadded_hash_matches_reference(n):
    e = _rand(n + 1000, n)
    assert np.array_equal(p2.unpadded_hash_np(e), rp2.unpadded_hash_np(e))


def test_kernel_checks_refuse_cpu_tensors():
    # the wrappers take the plain version for a CPU tensor; the kernel
    # path's own checks refuse one (there is no silent fallback)
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kntt._prepare(x, "evaluate_ntt")
    with pytest.raises(ValueError):
        kp2._require(x, "hash_rows", 2)
