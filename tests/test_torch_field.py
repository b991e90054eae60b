"""risc0_tpu_torch.field and core.ntt against the JAX package's field and
NTT on the same numpy inputs.  Field arithmetic is exact, so every
comparison is bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu.core import ntt as rntt
from risc0_tpu_torch import field as F
from risc0_tpu_torch.convert import to_numpy, to_torch
from risc0_tpu_torch.core import ntt

torch.set_num_threads(2)

# the words of tests/test_field.py::test_mul_edge_cases, plus neighbours
EDGE = np.array([0, 1, 2, RF.P - 1, RF.P - 2, RF.R, RF.R2,
                 (1 << 31) - (1 << 27), (1 << 27) + 5, RF.P // 2], np.uint32)


def _pairs():
    a, b = np.meshgrid(EDGE, EDGE)
    return a.ravel(), b.ravel()


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, RF.P, shape,
                                                dtype=np.uint32)


def test_constants_match_reference():
    for name in ("P", "M", "R", "R2", "BETA", "NBETA", "MONT_ONE",
                 "MONT_BETA", "MONT_NBETA"):
        assert getattr(F, name) == getattr(RF, name), name
    assert F.ROU_FWD == RF.ROU_FWD and F.ROU_REV == RF.ROU_REV
    assert (F.R_INV * (1 << 32)) % F.P == 1


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_edge_cases(op):
    a, b = _pairs()
    want = getattr(RF, f"{op}_np")(a, b)
    got = to_numpy(getattr(F, op)(to_torch(a), to_torch(b)))
    assert np.array_equal(got, want)
    jax_got = np.asarray(getattr(RF, op)(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, jax_got)


def test_unary_ops_edge_cases():
    a = EDGE
    assert np.array_equal(to_numpy(F.neg(to_torch(a))), RF.neg_np(a))
    assert np.array_equal(to_numpy(F.encode(to_torch(a))), RF.encode_np(a))
    assert np.array_equal(to_numpy(F.decode(to_torch(a))), RF.decode_np(a))
    assert np.array_equal(to_numpy(F.inv(to_torch(a))), RF.inv_np(a))
    assert np.array_equal(to_numpy(F.pow_static(to_torch(a), 12345)),
                          RF.pow_np(a, 12345))


def test_random_binary_ops():
    a, b = _rand(1, 4096), _rand(2, 4096)
    for op in ("add", "sub", "mul"):
        got = to_numpy(getattr(F, op)(to_torch(a), to_torch(b)))
        assert np.array_equal(got, getattr(RF, f"{op}_np")(a, b)), op


def test_ext_ops_match_reference():
    a, b = _rand(3, (257, 4)), _rand(4, (257, 4))
    a[0] = 0
    a[1] = RF.P - 1
    assert np.array_equal(to_numpy(F.ext_mul(to_torch(a), to_torch(b))),
                          RF.ext_mul_np(a, b))
    assert np.array_equal(to_numpy(F.ext_inv(to_torch(a))), RF.ext_inv_np(a))
    assert np.array_equal(to_numpy(F.ext_powers(to_torch(a[5]), 37)),
                          RF.ext_powers_np(a[5], 37))
    assert np.array_equal(F.ext_powers_np(a[5], 37),
                          RF.ext_powers_np(a[5], 37))


def test_host_helpers_are_the_reference():
    a, b = _rand(5, (64, 4)), _rand(6, (64, 4))
    assert np.array_equal(F.ext_mul_np(a, b), RF.ext_mul_np(a, b))
    assert np.array_equal(F.ext_inv_np(a), RF.ext_inv_np(a))
    for x in (0, 1, 5, RF.P - 1, 123456789):
        assert F.s_inv(F.s_encode(x)) == RF.s_inv(RF.s_encode(x))
        assert F.s_pow(x, 1000) == RF.s_pow(x, 1000)


def test_sum_mod_is_the_field_sum():
    x = _rand(7, (1000, 3))
    want = x[0]
    for row in x[1:]:
        want = RF.add_np(want, row)
    assert np.array_equal(to_numpy(F.sum_mod(to_torch(x), 0)), want)


def test_convert_roundtrip():
    a = _rand(8, (3, 5))
    t = to_torch(a)
    assert t.dtype == torch.int32 and (t >= 0).all()
    assert np.array_equal(to_numpy(t), a)


def test_tables_match_reference():
    for n_bits in (1, 4, 11):
        for fwd in (True, False):
            assert np.array_equal(ntt._twiddles(n_bits, fwd),
                                  rntt._twiddles(n_bits, fwd))
        assert np.array_equal(ntt._zk_shift_table(n_bits),
                              rntt._zk_shift_table(n_bits))
        assert np.array_equal(ntt._bitrev_perm(n_bits),
                              rntt._bitrev_perm(n_bits))


# jitted: eager jnp dispatches each stage op by op
_REF_EVALUATE = jax.jit(rntt.evaluate_ntt, static_argnums=1)
_REF_INTERPOLATE = jax.jit(rntt.interpolate_ntt)


@pytest.mark.parametrize("n_bits,expand_bits",
                         [(0, 0), (1, 0), (3, 0), (8, 0), (3, 2), (8, 2)])
def test_ntt_matches_reference(n_bits, expand_bits):
    x = _rand(n_bits, (3, 1 << n_bits))
    want = np.asarray(_REF_EVALUATE(jnp.asarray(x), expand_bits))
    assert np.array_equal(to_numpy(ntt.evaluate_ntt(to_torch(x),
                                                    expand_bits)), want)
    assert np.array_equal(ntt.evaluate_ntt_np(x, expand_bits),
                          rntt.evaluate_ntt_np(x, expand_bits))
    want = np.asarray(_REF_INTERPOLATE(jnp.asarray(x)))
    assert np.array_equal(to_numpy(ntt.interpolate_ntt(to_torch(x))), want)
    assert np.array_equal(ntt.interpolate_ntt_np(x),
                          rntt.interpolate_ntt_np(x))


def test_poly_helpers_match_reference():
    x = _rand(9, (2, 64))
    xt = to_torch(x)
    for fn in ("bit_reverse", "zk_shift"):
        want = np.asarray(getattr(rntt, fn)(jnp.asarray(x)))
        assert np.array_equal(to_numpy(getattr(ntt, fn)(xt)), want), fn
    assert np.array_equal(to_numpy(ntt.expand(xt, 2)),
                          np.asarray(rntt.expand(jnp.asarray(x), 2)))
