"""The Poseidon2 kernels' schedule (risc0_tpu_torch/csrc/poseidon2.cu)
modelled on the CPU, and the Merkle fold's plan and plain version.

`_Schedule` is the kernel's permutation written in the kernel's order with
the kernel's lazy reductions, on int64 tensors.  It runs in two modes: exact words (checked against the port's plain `permute` and the
JAX package's `permute_np`) and worst-case bounds, where every input word
is at the largest value its stated bound allows and each op returns the
largest value it could give.  Both modes assert, at every step, each bound
the kernel's comments state: every 32-bit word below 2^32, every REDC
input below P * 2^32 and every reduce64 input below 2^39.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu.hash import poseidon2 as rp2
from risc0_tpu_torch import field as F
from risc0_tpu_torch.convert import to_numpy, to_torch
from risc0_tpu_torch.hal import torch_hal
from risc0_tpu_torch.hal.cuda import poseidon2 as kp2
from risc0_tpu_torch.hash import poseidon2 as p2

torch.set_num_threads(2)

P = F.P
W32 = 1 << 32
P_INV = pow(P, -1, W32)
B_RED = 1.01  # reduce64's output bound, in units of P


class _Schedule:
    """poseidon2.cu's permute() on (n, 24) int64 words (exact=True) or on
    (24,) worst-case bounds (exact=False; each value is exclusive)."""

    def __init__(self, exact: bool):
        self.exact = exact
        self.rcf = torch.from_numpy(
            kp2.folded_round_constants().astype(np.int64))
        self.mint = torch.from_numpy(p2.MINT_MONT.astype(np.int64))
        if not exact:  # constants: any canonical word
            self.rcf = torch.where(self.rcf > 0, P, 1)
            self.mint = torch.full_like(self.mint, P)

    def below(self, x, limit, what):
        """Every value of x is below limit (a bound x is exclusive)."""
        top = int(x.max()) - (0 if self.exact else 1)
        assert top < limit, f"{what}: {top} >= {limit}"

    def word(self, x, bound_p, what):
        """x is a 32-bit word below bound_p * P."""
        self.below(x, W32, what)
        self.below(x, int(bound_p * P), what)
        return x

    def mul_lazy(self, a, b, what):
        self.below(a, W32, what)
        self.below(b, W32, what)
        if not self.exact:
            t = (a - 1) * (b - 1) + 1
            self.below(t, P * W32, f"{what}: redc input")
            return (t - 1) // W32 + P + 1
        assert (a.double() * b.double() < P * float(W32)).all(), what
        t = a * b
        self.below(t, P * W32, f"{what}: redc input")
        m = (t & (W32 - 1)) * P_INV & (W32 - 1)
        return (t >> 32) + P - ((m * P) >> 32)

    def sub_p(self, x, what):
        self.below(x, W32, what)
        if not self.exact:
            return torch.clamp(x - P, min=P)
        return torch.where(x >= P, x - P, x)

    def reduce64(self, v, what):
        self.below(v, 1 << 39, f"{what}: reduce64 input")
        if not self.exact:
            # q falls short of v / P by < 1 + 1/240 + (v / P) 2^-16
            slack = (v - 1).double() / P * 2**-16 * P
            return P + P // 240 + slack.ceil().long() + 2
        q = ((v >> 23) * 34952) >> 23
        r = v - q * P
        assert int(r.min()) >= 0, what
        self.below(r, int(B_RED * P), f"{what}: reduce64 output")
        return r

    def sbox(self, x):
        x = self.word(x, B_RED, "sbox input")
        x2 = self.sub_p(self.mul_lazy(x, x, "x^2"), "x^2")
        x2 = self.word(x2, 1, "x^2")
        x4 = self.word(self.mul_lazy(x2, x2, "x^4"), 1.47, "x^4")
        x6 = self.word(self.mul_lazy(x4, x2, "x^6"), 1.69, "x^6")
        return self.word(self.mul_lazy(x6, x, "x^7"), 1.85, "x^7")

    @staticmethod
    def m4(a, b, c, d):
        t0, t1 = a + b, c + d
        t2, t3 = b + b + t1, d + d + t0
        t4, t5 = 4 * t1 + t3, 4 * t0 + t2
        return [t3 + t5, t5, t2 + t4, t4]

    def ext_layer(self, c, nxt):
        for i in range(24):
            self.word(c[..., i], 1.85, "external layer input")
        col = [sum(c[..., 4 * b + j] for b in range(6)) for j in range(4)]
        s = self.m4(*col)
        out = []
        for blk in range(6):
            o = self.m4(*(c[..., 4 * blk + j] for j in range(4)))
            for j in range(4):
                v = o[j] + s[j] + self.rcf[nxt, 4 * blk + j]
                out.append(self.reduce64(v, "external layer"))
        return torch.stack(out, -1)

    def full_round(self, c, rnd):
        c = torch.stack([self.sbox(c[..., i]) for i in range(24)], -1)
        return self.ext_layer(c, rnd + 1)

    def partial_round(self, c, rnd):
        self.word(c[..., 0], B_RED, "partial round cell 0")
        for i in range(1, 24):
            self.word(c[..., i], 1 + B_RED, "partial round cell")
        y0 = self.sbox(c[..., 0])
        cells = [y0] + [c[..., i] for i in range(1, 24)]
        s = [cells[3 * k] + cells[3 * k + 1] + cells[3 * k + 2]
             for k in range(8)]
        total = (s[0] + s[1] + s[2]) + (s[3] + s[4] + s[5]) + (s[6] + s[7])
        t = self.reduce64(total, "internal sum")
        out = [None] * 24
        for i in range(1, 24):
            z = self.sub_p(self.mul_lazy(cells[i], self.mint[i], "diag"),
                           "diag")
            self.word(z, 1, "diag product")
            out[i] = self.word(t + z, 1 + B_RED, "internal layer out")
        z0 = self.word(self.sub_p(self.mul_lazy(y0, self.mint[0], "diag 0"),
                                  "diag 0"), 1, "diag 0")
        u = self.sub_p(self.word(t + self.rcf[rnd + 1, 0], 1 + B_RED,
                                 "t + rc"), "t + rc")
        out[0] = self.sub_p(self.word(u + z0, 1 + B_RED, "cell 0"), "cell 0")
        return torch.stack(out, -1)

    def permute(self, c):
        c = self.ext_layer(c, 0)
        for rnd in range(4):
            c = self.full_round(c, rnd)
        for rnd in range(4, 25):
            c = self.partial_round(c, rnd)
        out = [c[..., 0]]
        for i in range(1, 24):
            u = self.word(self.sub_p(c[..., i], "transition") +
                          self.rcf[25, i], 1 + B_RED, "transition")
            out.append(self.sub_p(u, "transition"))
        c = torch.stack(out, -1)
        for rnd in range(25, 29):
            c = self.full_round(c, rnd)
        for i in range(24):
            self.word(c[..., i], B_RED, "permutation output")
        return c


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, RF.P, shape,
                                                dtype=np.uint32)


def _edge_states():
    rng = np.random.default_rng(7)
    mixed = rng.choice(np.array([0, 1, P - 1, P - 2, F.R % P], np.uint32),
                       (6, 24))
    return np.concatenate([np.zeros((1, 24), np.uint32),
                           np.full((1, 24), P - 1, np.uint32), mixed])


def test_folded_constants_are_the_round_constants():
    rcf = kp2.folded_round_constants()
    assert rcf.shape == (p2.ROUNDS + 1, 24)
    for r in range(p2.ROUNDS):
        if 4 <= r < 25:
            assert rcf[r, 0] == p2.RC_MONT[r, 0] and not rcf[r, 1:].any()
        else:
            assert np.array_equal(rcf[r], p2.RC_MONT[r])
    assert not rcf[p2.ROUNDS].any()


def test_schedule_bounds_hold_for_worst_case_words():
    # every input word at the largest value permute() accepts (< 1.85P)
    _Schedule(exact=False).permute(
        torch.full((24,), int(1.85 * P), dtype=torch.int64))


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_schedule_matches_permute(kind):
    s = _rand(11, (64, 24)) if kind == "random" else _edge_states()
    got = _Schedule(exact=True).permute(torch.from_numpy(s.astype(np.int64)))
    got = torch.where(got >= P, got - P, got)  # the callers' final sub_p
    want = rp2.permute_np(s)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(to_numpy(p2.permute(to_torch(s))), want)


def test_schedule_accepts_unreduced_inputs():
    # the capacity words a sponge carries between permutations are below
    # 1.01P, not canonical: the same field element gives the same output
    s = _rand(12, (16, 24))
    lazy = s.astype(np.int64)
    low = lazy < int((B_RED - 1) * P)
    lazy[low] += P
    sched = _Schedule(exact=True)
    a = sched.permute(torch.from_numpy(lazy))
    b = sched.permute(torch.from_numpy(s.astype(np.int64)))
    assert torch.equal(a % P, b % P)


@pytest.mark.parametrize("n_bits", range(0, 25))
def test_fold_plan_covers_every_layer_once(n_bits):
    plan = kp2.fold_plan(n_bits)
    assert sum(plan) == n_bits
    assert all(1 <= levels <= kp2.FOLD_LEVELS for levels in plan)
    assert plan == sorted(plan)  # narrow launches at the wide bottom


def test_fold_plan_of_the_prove():
    # four trees of 2^22 leaves (data, accum, code, check) and the FRI
    # trees of 2^18, 2^14 and 2^10 leaves: 22 launches, against 130 before
    assert kp2.fold_plan(22) == [2, 2, 9, 9]
    assert 4 * len(kp2.fold_plan(22)) + sum(
        len(kp2.fold_plan(k)) for k in (18, 14, 10)) == 22


def _reference_layers(leaves):
    layers, cur = [leaves], jnp.asarray(leaves)
    while cur.shape[0] > 1:
        cur = rp2.hash_pairs(cur[0::2], cur[1::2])
        layers.append(np.asarray(cur))
    return layers


@pytest.mark.parametrize("n", [1, 2, 4, 16, 1 << 10])
def test_merkle_fold_matches_reference(n):
    leaves = _rand(n + 5, (n, 8))
    got = kp2.merkle_fold(to_torch(leaves))
    want = _reference_layers(leaves)
    assert len(got) == len(want) - 1
    for g, w in zip(got, want[1:]):
        assert np.array_equal(to_numpy(g), w)


@pytest.mark.parametrize("rows", [1, 16])
def test_merkle_layers_matches_reference(rows):
    m = _rand(rows, (3, rows))
    got = torch_hal.merkle_layers(to_torch(m))
    want = _reference_layers(np.asarray(rp2.hash_rows(jnp.asarray(m))))
    assert [to_numpy(g).tolist() for g in got] == [w.tolist() for w in want]


@pytest.mark.parametrize("n", [3, 6])
def test_merkle_fold_refuses_a_tree_that_is_not_a_power_of_two(n):
    # the prover's trees are powers of two (prove/merkle.py merkle_params)
    with pytest.raises(ValueError):
        kp2.merkle_fold(torch.zeros((n, 8), dtype=torch.int32))
