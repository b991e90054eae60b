"""The plain torch versions of the four CUDA kernels (the CPU path of their
wrappers) against the JAX package on the same numpy inputs: the Pallas NTT
kernels in interpret mode and core/ntt, the Poseidon2 hash_rows/hash_pairs
(jnp path on the CPU) and permute_np.  Field arithmetic is exact, so
every comparison is bit for bit.  The kernels themselves are compared with
these plain versions on the card in tests/test_torch_cuda.py."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu.core import ntt as rntt
from risc0_tpu.hal.pallas import ntt as pntt
from risc0_tpu.hash import poseidon2 as rp2
from risc0_tpu_torch import field as F
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


# -- the two-pass CUDA design, modelled on the CPU --------------------------
#
# _two_pass is the kernels' schedule in plain torch: the same split, the
# same host tables, the same rounds of up to three stages and the same
# group/twiddle index arithmetic as csrc/ntt.cu, vectorised over groups.

def _round(x, bits, l, s, fwd, tw):
    """Stages l..l+s-1 along the last axis (2^bits); tw(stage, j) -> words
    broadcastable against x[..., groups]."""
    g = torch.arange(1 << (bits - s))
    j0 = g & ((1 << (l - 1)) - 1)
    base = ((g >> (l - 1)) << (l + s - 1)) + j0
    idx = base[:, None] + (torch.arange(1 << s) << (l - 1))[None, :]
    v = [x[..., idx[:, t]] for t in range(1 << s)]
    for u in (range(s) if fwd else reversed(range(s))):
        for t in range(1 << s):
            if t & (1 << u):
                continue
            w = tw(l + u, j0 + ((t & ((1 << u) - 1)) << (l - 1)))
            a, b = v[t], v[t + (1 << u)]
            if fwd:
                bt = F.mul(b, w)
                v[t], v[t + (1 << u)] = F.add(a, bt), F.sub(a, bt)
            else:
                v[t], v[t + (1 << u)] = F.add(a, b), F.mul(F.sub(a, b), w)
    x = x.clone()
    for t in range(1 << s):
        x[..., idx[:, t]] = v[t]
    return x


def _stages(x, bits, lo, hi, fwd, tw):
    done, count = 0, hi + 1 - lo
    while done < count:
        s = min(3, count - done)
        l = lo + done if fwd else hi + 1 - done - s
        x = _round(x, bits, l, s, fwd, tw)
        done += s
    return x


def _two_pass(x, fwd, expand_bits=0):
    batch, n = x.shape
    n_bits = n.bit_length() - 1
    k1, k2 = kntt.split(n_bits)
    assert k1 + k2 == n_bits
    local, outer = (torch.from_numpy(t.view(np.int32))
                    for t in kntt.host_tables(n_bits, fwd))

    def local_tw(l, j):
        return local[(1 << (l - 1)) - 1 + j]

    def contiguous(x, lo):
        y = _stages(x.reshape(batch, -1, 1 << k1), k1, lo, k1, fwd, local_tw)
        return y.reshape(batch, n)

    def strided(x, mlo):
        # (batch, r, q): offset r < 2^k1 is a lane, q < 2^k2 the transform
        y = x.reshape(batch, 1 << k2, 1 << k1).transpose(1, 2)
        b_tab = outer.reshape(max(k2, 1), 1 << k1)

        def tw(m, j):
            return F.mul(local_tw(m, j)[None, :], b_tab[m - 1][:, None])

        y = _stages(y, k2, mlo, k2, fwd, tw)
        return y.transpose(1, 2).reshape(batch, n)

    if fwd:
        if expand_bits < k1:
            x = contiguous(x, expand_bits + 1)
        if k2 and expand_bits < n_bits:
            x = strided(x, max(1, expand_bits - k1 + 1))
        return x
    if k2:
        x = strided(x, 1)
    norm = F.s_inv(F.s_encode(n % F.P))
    return F.mul(contiguous(x, 1), norm)


def test_split_fits_the_kernels():
    """What csrc/ntt.cu's valid() takes: two passes up to 2^24, a tile 16
    or 32 offsets wide inside 2^k1, and both blocks within 2^BLOCK_BITS
    words of shared memory."""
    for n_bits in range(28):
        k1, k2 = kntt.split(n_bits)
        assert k1 <= kntt.BLOCK_BITS and k1 + k2 == min(n_bits, 24)
        if k2 == 0:
            assert k1 == n_bits
            continue
        cb = kntt.cols_bits(k2)
        assert cb in (4, 5) and k1 >= cb and k2 + cb <= kntt.BLOCK_BITS
        assert cb == kntt.COLS_BITS or n_bits >= 24


@pytest.mark.parametrize("n_bits", [12, 14, 22, 24])
@pytest.mark.parametrize("fwd", [True, False])
def test_host_tables_are_the_pallas_tables(n_bits, fwd):
    local, outer = kntt.host_tables(n_bits, fwd)
    k1, k2 = kntt.split(n_bits)
    assert k1 + k2 == n_bits
    for l, tab in enumerate(pntt._stage_tables(n_bits, fwd, 1, k1), 1):
        assert np.array_equal(local[(1 << (l - 1)) - 1:(1 << l) - 1], tab)
    outer_tabs = pntt._outer_tables(n_bits, fwd, k1)
    assert len(outer_tabs) == k2
    for m, (a_tab, b_tab) in enumerate(outer_tabs, 1):
        assert np.array_equal(local[(1 << (m - 1)) - 1:(1 << m) - 1], a_tab)
        assert np.array_equal(outer[(m - 1) << k1:m << k1], b_tab)


def _model_input(n_bits, expand_bits):
    c = _rand(n_bits * 7 + expand_bits, (3, 1 << (n_bits - expand_bits)))
    return np.repeat(c, 1 << expand_bits, axis=-1)


@lru_cache(maxsize=None)
def _pallas_rows(n_bits, expand_bits, fwd):
    """The Pallas kernels (interpret mode) on the 3-row model input; the
    kernels pad the batch to 8 rows, so row i does not depend on the
    batch, and batch 1 reads row 0 of the same call."""
    x = jnp.asarray(_model_input(n_bits, expand_bits))
    if fwd:
        return np.asarray(pntt.evaluate_ntt(x, expand_bits, interpret=True))
    return np.asarray(pntt.interpolate_ntt(x, interpret=True))


@pytest.mark.parametrize("n_bits", [12, 14])
@pytest.mark.parametrize("expand_bits", [0, 2])
@pytest.mark.parametrize("batch", [1, 3])
def test_two_pass_model_matches_pallas_and_core(n_bits, expand_bits, batch):
    x = _model_input(n_bits, expand_bits)[:batch]
    want = _pallas_rows(n_bits, expand_bits, True)[:batch]
    assert np.array_equal(to_numpy(ntt.evaluate_ntt(to_torch(x),
                                                    expand_bits)), want)
    assert np.array_equal(to_numpy(_two_pass(to_torch(x), True,
                                             expand_bits)), want)
    if expand_bits == 0:
        want = _pallas_rows(n_bits, 0, False)[:batch]
        assert np.array_equal(to_numpy(ntt.interpolate_ntt(to_torch(x))),
                              want)
        assert np.array_equal(to_numpy(_two_pass(to_torch(x), False)), want)


# larger splits (k2 = 4 and 8: rounds of 3 + 1 and 3 + 3 + 2 stages)
@pytest.mark.parametrize("n_bits,expand_bits", [(16, 0), (16, 13), (20, 2)])
def test_two_pass_model_matches_core(n_bits, expand_bits):
    x = to_torch(_rand(n_bits + expand_bits, (1, 1 << n_bits)))
    assert torch.equal(_two_pass(x, True, expand_bits),
                       ntt.evaluate_ntt(x, expand_bits))
    if expand_bits == 0:
        assert torch.equal(_two_pass(x, False), ntt.interpolate_ntt(x))


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
