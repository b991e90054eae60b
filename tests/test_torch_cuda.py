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


@pytest.mark.parametrize("cols", [0, 1, 15, 16, 17, 64, 211])
@pytest.mark.parametrize("rows", [1, 37, 1024])
def test_hash_rows_kernel(dev, cols, rows):
    rng = np.random.default_rng(cols * 1000 + rows)
    m = _words(rng, (cols, rows), dev)
    assert torch.equal(kp2.hash_rows(m), kp2.hash_rows_plain(m))


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


@pytest.mark.parametrize("n_bits", [2, 3, 11, 13, 15])
def test_ntt_expand_kernel(dev, n_bits):
    rng = np.random.default_rng(n_bits)
    c = _words(rng, (5, 1 << (n_bits - 2)), dev)
    x = ntt_mod.expand(c, 2).contiguous()
    assert torch.equal(kntt.evaluate_ntt(x, 2), kntt.evaluate_ntt_plain(x, 2))


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
