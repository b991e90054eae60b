"""Card-only checks of the CUDA kernels of risc0_tpu_torch against their
plain torch versions, on the same CUDA inputs.  Field arithmetic is exact,
so every comparison is bit for bit (torch.equal).

These skip where torch sees no CUDA device.  This file imports no jax, so
it also runs on a machine without it:

    RISC0_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.core import ntt as ntt_mod
from risc0_tpu_torch.hal.cuda import ntt as kntt
from risc0_tpu_torch.hal.cuda import poseidon2 as kp2

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, shape, dev):
    return torch.from_numpy(
        rng.integers(0, F.P, shape, dtype=np.uint32).view(np.int32)).to(dev)


def test_field_edge_words_through_ntt(dev):
    # the edge words of test_mul_edge_cases go through the kernels'
    # Montgomery product: a 2-point NTT is add/sub of x0 and x1*W
    edge = np.array([0, 1, F.P - 1, F.R, (1 << 31) - (1 << 27), F.P - 2],
                    np.uint32)
    x = torch.from_numpy(np.stack(np.meshgrid(edge, edge), -1)
                         .reshape(-1, 2).view(np.int32)).to(dev).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


@pytest.mark.parametrize("cols", [0, 1, 15, 16, 17, 64, 103, 211, 1024])
@pytest.mark.parametrize("rows", [1, 37, 1024])
def test_hash_rows_kernel(dev, cols, rows):
    rng = np.random.default_rng(cols * 1000 + rows)
    m = _words(rng, (cols, rows), dev)
    assert torch.equal(kp2.hash_rows(m), kp2.hash_rows_plain(m))


def _edge_words(dev, shape):
    # all 0, all P - 1, and the edge words mixed (the lazy reductions'
    # extremes: 0, 1, P - 1, P - 2 and the Montgomery one)
    rng = np.random.default_rng(17)
    mixed = rng.choice(np.array([0, 1, F.P - 1, F.P - 2, F.R % F.P],
                                np.uint32), shape)
    out = [np.zeros(shape, np.uint32), np.full(shape, F.P - 1, np.uint32),
           mixed]
    return [torch.from_numpy(a.view(np.int32)).to(dev) for a in out]


@pytest.mark.parametrize("cols", [1, 16, 17, 211])
def test_hash_rows_kernel_edge_words(dev, cols):
    for m in _edge_words(dev, (cols, 64)):
        assert torch.equal(kp2.hash_rows(m), kp2.hash_rows_plain(m))


def test_pair_kernels_edge_words(dev):
    for leaves in _edge_words(dev, (64, 8)):
        assert torch.equal(kp2.hash_pairs(leaves[0::2], leaves[1::2]),
                           kp2.hash_pairs_plain(leaves[0::2], leaves[1::2]))
        for got, want in zip(kp2.merkle_fold(leaves),
                             kp2.merkle_fold_plain(leaves)):
            assert torch.equal(got, want)


# every boundary of the fold plan: one launch up to 2^9 leaves, then a
# second launch of 1 to 3 levels; 2^22 is the prove's tree (9 + 9 + 4)
@pytest.mark.parametrize("n_bits", list(range(13)) + [22])
def test_merkle_fold_kernel(dev, n_bits):
    leaves = _words(np.random.default_rng(n_bits), (1 << n_bits, 8), dev)
    got = kp2.merkle_fold(leaves)
    want = kp2.merkle_fold_plain(leaves)
    assert len(got) == len(want) == n_bits
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_merkle_fold_counts_its_launches(dev):
    leaves = _words(np.random.default_rng(2), (1 << 20, 8), dev)
    before = kp2.hash_pairs.launches
    kp2.merkle_fold(leaves)
    assert kp2.hash_pairs.launches - before == len(kp2.fold_plan(20)) == 3


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4096])
def test_hash_pairs_kernel(dev, n):
    rng = np.random.default_rng(n)
    layer = _words(rng, (2 * n, 8), dev)
    left, right = layer[0::2], layer[1::2]
    assert torch.equal(kp2.hash_pairs(left, right),
                       kp2.hash_pairs_plain(left, right))


@pytest.mark.parametrize("n_bits", [0, 1, 2, 5, 10, 11, 12, 14, 16])
@pytest.mark.parametrize("batch", [1, 3])
def test_ntt_kernels(dev, n_bits, batch):
    rng = np.random.default_rng(n_bits * 10 + batch)
    x = _words(rng, (batch, 1 << n_bits), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


# n_bits 17-24: every (k1, k2) split of the two-pass kernels, up to the
# 64 KB strided tile at k2 = 10 (n_bits 24)
@pytest.mark.parametrize("n_bits", list(range(17, 25)))
@pytest.mark.parametrize("batch", [1, 2])
def test_ntt_kernels_large(dev, n_bits, batch):
    rng = np.random.default_rng(n_bits * 10 + batch)
    x = _words(rng, (batch, 1 << n_bits), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


def test_ntt_kernels_batch_above_one_tile(dev):
    # 9 rows: above the 8-row batch tile of the Pallas kernels
    x = _words(np.random.default_rng(9), (9, 1 << 14), dev)
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


@pytest.mark.parametrize("n_bits", [2, 3, 11, 13, 15, 22])
def test_ntt_expand_kernel(dev, n_bits):
    rng = np.random.default_rng(n_bits)
    c = _words(rng, (5, 1 << (n_bits - 2)), dev)
    x = ntt_mod.expand(c, 2).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x, 2), kntt.evaluate_ntt_plain(x, 2))


# expand_bits at or above k1: the contiguous pass is skipped and the
# strided pass starts above its first stage (or is skipped too)
@pytest.mark.parametrize("n_bits,expand_bits", [(14, 12), (16, 13), (20, 15),
                                                (12, 12), (14, 14)])
def test_ntt_expand_at_or_above_k1(dev, n_bits, expand_bits):
    assert expand_bits >= kntt.split(n_bits)[0]
    rng = np.random.default_rng(n_bits + expand_bits)
    c = _words(rng, (2, 1 << (n_bits - expand_bits)), dev)
    x = ntt_mod.expand(c, expand_bits).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x, expand_bits),
                       kntt.evaluate_ntt_plain(x, expand_bits))


def test_ntt_misaligned_view(dev):
    # a row view that starts 4 bytes into its storage is copied first
    base = _words(np.random.default_rng(3), (1, 1 + (2 << 13)), dev)
    x = base[0, 1:].reshape(2, 1 << 13)
    assert x.data_ptr() % 16
    assert torch.equal(kntt.evaluate_ntt(x), kntt.evaluate_ntt_plain(x))
    assert torch.equal(kntt.interpolate_ntt(x), kntt.interpolate_ntt_plain(x))


def test_ntt_roundtrip_kernel(dev):
    rng = np.random.default_rng(5)
    x = _words(rng, (4, 1 << 15), dev)
    assert torch.equal(kntt.evaluate_ntt(kntt.interpolate_ntt(x)), x)


def test_wrappers_count_launches(dev):
    x = _words(np.random.default_rng(1), (2, 64), dev)
    before = (kntt.evaluate_ntt.launches, kp2.hash_rows.launches)
    kntt.evaluate_ntt(x)
    kp2.hash_rows(x)
    assert (kntt.evaluate_ntt.launches, kp2.hash_rows.launches) == \
        (before[0] + 1, before[1] + 1)
