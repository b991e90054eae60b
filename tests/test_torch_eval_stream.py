"""The range plan's op stream (``ir_range.encode_plan``), which the plan
interpreter (``csrc/eval_plan.cu``) runs on the card.

The stream must give back every group of the rv32im, recursion and keccak
plans, and of a small plan with every group kind.  ``_model`` walks the
stream as the kernel does, word by word with the kernel's formulas
(numpy field ops, its ext product's constant), and must equal the plain
twin ``_run_chunk`` on the same staged file; the kernel itself runs only
on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.circuit import ir_range
from risc0_tpu_torch.hal.cuda import eval_plan as keval

EDGE = np.array([0, 1, F.P - 1], np.uint32)


def _circuit(name):
    if name == "rv32im":
        from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit
        return load_circuit()
    if name == "recursion":
        from risc0_tpu_torch.circuit.recursion.circuit import \
            load_prover_circuit
        return load_prover_circuit()
    from risc0_tpu_torch.circuit.keccak.circuit import load_circuit
    return load_circuit()


def _plan(name):
    return _synthetic_plan() if name == "synthetic" else \
        ir_range._range_plan(_circuit(name))


def _synthetic_plan():
    """Every group kind once or more: fp rows 0-1 constants, 2-4 taps, 5 a
    global; ext row 0 a constant.  A chain with all three term kinds, an
    fsum with negative signs and a padded sum."""
    i32 = np.int32
    groups = [
        ("fadd", 6, np.array([2, 3], i32), np.array([4, 5], i32)),
        ("fsub", 8, np.array([6], i32), np.array([2], i32)),
        ("fmul", 9, np.array([7, 8], i32), np.array([3, 0], i32)),
        ("fsum", 11, np.array([[2, 6, 9], [3, 0, 0]], i32),
         np.array([[1, -1, -1], [-1, 0, 0]], np.int8)),
        ("eadd", 1, np.array([0], i32), np.array([0], i32)),
        ("esub", 2, np.array([1], i32), np.array([0], i32)),
        ("emul", 3, np.array([1, 2], i32), np.array([2, 0], i32)),
        ("escale", 5, np.array([3], i32), np.array([11], i32)),
        ("eaddf", 6, np.array([4], i32), np.array([12], i32)),
        ("esubf", 7, np.array([5], i32), np.array([6], i32)),
        ("fsube", 8, np.array([10], i32), np.array([7], i32)),
        ("chain", {"dst": 9, "acc": 8,
                   "t1f": np.array([[0, 2], [3, 12]], i32),
                   "te": np.array([[1, 6]], i32),
                   "tfe": np.array([[2, 9, 3], [4, 8, 5]], i32)}),
    ]
    rng = np.random.default_rng(16)
    return ir_range.RangePlan(
        const_vals=F.encode_np(np.array([3, 7], np.uint32)),
        tap_specs=[(0, 0, 0), (1, 0, 0), (1, 1, 1)],
        global_specs=[(0, 0)],
        econst_vals=rng.integers(0, F.P, (1, 4), dtype=np.uint32),
        fp_rows=13, ext_rows=10, groups=groups, ret_row=9)


def _same_group(got, want):
    assert got[0] == want[0]
    if want[0] == "chain":
        assert (got[1]["dst"], got[1]["acc"]) == (want[1]["dst"],
                                                  want[1]["acc"])
        for key in ("t1f", "te", "tfe"):
            assert np.array_equal(got[1][key], want[1][key]), key
        return
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["rv32im", "recursion", "keccak",
                                  "synthetic"])
def test_op_stream_round_trips(name):
    plan = _plan(name)
    words = ir_range.encode_plan(plan)
    assert words.dtype == np.int32
    head, groups = ir_range.decode_plan(words)
    mixes = max([int(g[1][k][:, 0].max()) + 1 for g in plan.groups
                 if g[0] == "chain" for k in ("t1f", "te", "tfe")
                 if len(g[1][k])] + [0])
    assert head == (plan.fp_rows, plan.ext_rows, mixes, len(plan.groups))
    assert len(groups) == len(plan.groups)
    for got, want in zip(groups, plan.groups):
        _same_group(got, want)


def test_synthetic_plan_holds_every_group_kind():
    groups = _synthetic_plan().groups
    assert {g[0] for g in groups} == set(ir_range.OPCODES)
    chain = [g[1] for g in groups if g[0] == "chain"][0]
    assert all(len(chain[k]) for k in ("t1f", "te", "tfe"))


@pytest.mark.parametrize("name,read,written", [
    ("rv32im", 178_772, 76_044), ("recursion", 79_092, 31_248),
    ("keccak", 322_252, 106_912)])
def test_stream_row_bytes(name, read, written):
    # the kernel's byte bound, as its source note gives it
    assert ir_range.stream_row_bytes(
        ir_range.encode_plan(_plan(name))) == (read, written)


def _e_mul(a, b):
    """The kernel's F_p4 product (e_mul) on (..., 4) uint32 words."""
    m, ad = F.mul_np, F.add_np
    a0, a1, a2, a3 = np.moveaxis(a, -1, 0)
    b0, b1, b2, b3 = np.moveaxis(b, -1, 0)
    nb = np.uint32(F.MONT_NBETA)  # csrc/eval_plan.cu's MONT_NBETA
    c0 = ad(m(a0, b0), m(nb, ad(ad(m(a1, b3), m(a2, b2)), m(a3, b1))))
    c1 = ad(ad(m(a0, b1), m(a1, b0)), m(nb, ad(m(a2, b3), m(a3, b2))))
    c2 = ad(ad(ad(m(a0, b2), m(a1, b1)), m(a2, b0)), m(nb, m(a3, b3)))
    c3 = ad(ad(ad(m(a0, b3), m(a1, b2)), m(a2, b1)), m(a3, b0))
    return np.stack([c0, c1, c2, c3], -1)


def _e_scale(a, s):
    return F.mul_np(a, s[..., None])


def _model(words, fp, ext, pm):
    """The kernel's walk of the op stream over every row of a chunk at
    once: fp (fp_rows, T), ext (ext_rows, T, 4), pm (n, 4) uint32, in
    place."""
    w = np.asarray(words, np.int64)
    op_of = {v: k for k, v in ir_range.OPCODES.items()}
    u64, p = np.uint64, np.uint64(F.P)
    pc = ir_range.STREAM_HEAD
    while pc < len(w):
        kind = op_of[int(w[pc])]
        if kind == "chain":
            dst, acc, n1, n2, n3 = (int(x) for x in w[pc + 1:pc + 6])
            pc += 6
            c = ext[acc].astype(u64)
            t = w[pc:pc + 2 * n1].reshape(-1, 2)
            c += _e_scale(pm[t[:, 0], None, :], fp[t[:, 1]]).astype(
                u64).sum(0)
            pc += 2 * n1
            t = w[pc:pc + 2 * n2].reshape(-1, 2)
            c += _e_mul(pm[t[:, 0], None, :], ext[t[:, 1]]).astype(u64).sum(0)
            pc += 2 * n2
            t = w[pc:pc + 3 * n3].reshape(-1, 3)
            c += _e_mul(_e_scale(pm[t[:, 0], None, :], fp[t[:, 1]]),
                        ext[t[:, 2]]).astype(u64).sum(0)
            pc += 3 * n3
            ext[dst] = (c % p).astype(np.uint32)
            continue
        n, dst = int(w[pc + 1]), int(w[pc + 2])
        if kind == "fsum":
            pc += 3
            for i in range(n):
                length = int(w[pc])
                leaves = w[pc + 1:pc + 1 + length]
                v = fp[leaves >> 1].astype(u64)
                v = np.where((leaves & 1)[:, None] == 1, p - v, v)
                fp[dst + i] = (v.sum(0) % p).astype(np.uint32)
                pc += 1 + length
            continue
        ab = w[pc + 3:pc + 3 + 2 * n].reshape(n, 2)
        a, b = ab[:, 0], ab[:, 1]
        pc += 3 + 2 * n
        rows = slice(dst, dst + n)
        if kind == "fadd":
            fp[rows] = F.add_np(fp[a], fp[b])
        elif kind == "fsub":
            fp[rows] = F.sub_np(fp[a], fp[b])
        elif kind == "fmul":
            fp[rows] = F.mul_np(fp[a], fp[b])
        elif kind == "eadd":
            ext[rows] = F.add_np(ext[a], ext[b])
        elif kind == "esub":
            ext[rows] = F.sub_np(ext[a], ext[b])
        elif kind == "emul":
            ext[rows] = _e_mul(ext[a], ext[b])
        elif kind == "escale":
            ext[rows] = _e_scale(ext[a], fp[b])
        elif kind in ("eaddf", "esubf"):
            out = ext[a].copy()
            fn = F.add_np if kind == "eaddf" else F.sub_np
            out[..., 0] = fn(out[..., 0], fp[b])
            ext[rows] = out
        else:  # fsube
            e = ext[b]
            ext[rows] = np.concatenate(
                [F.sub_np(fp[a], e[..., 0])[..., None],
                 F.sub_np(np.zeros_like(e[..., 1:]), e[..., 1:])], -1)


def staged_file(plan, T, seed):
    """(fp, ext, pm) uint32 arrays of one chunk with its inputs staged:
    the plan's constants, random canonical taps, globals and mix powers
    with the edge words 0, 1 and P - 1 among them; every op row 0."""
    rng = np.random.default_rng(seed)
    nc, nt, ng = (len(plan.const_vals), len(plan.tap_specs),
                  len(plan.global_specs))
    fp = np.zeros((plan.fp_rows, T), np.uint32)
    fp[:nc] = plan.const_vals[:, None]
    fp[nc:nc + nt] = rng.integers(0, F.P, (nt, T), dtype=np.uint32)
    fp[nc:nc + nt, :3] = EDGE
    fp[nc + nt:nc + nt + ng] = rng.choice(
        np.concatenate([EDGE, rng.integers(0, F.P, 8, dtype=np.uint32)]),
        (ng, 1))
    ext = np.zeros((plan.ext_rows, T, 4), np.uint32)
    ext[:len(plan.econst_vals)] = plan.econst_vals[:, None, :]
    head = ir_range.encode_plan(plan)[:ir_range.STREAM_HEAD]
    pm = rng.integers(0, F.P, (max(int(head[2]), 3), 4), dtype=np.uint32)
    pm[:3] = EDGE[:, None]
    return fp, ext, pm


@pytest.mark.parametrize("name", ["synthetic", "rv32im", "recursion",
                                  "keccak"])
def test_kernel_model_equals_run_chunk(name):
    plan = _plan(name)
    T = 4
    fp, ext, pm = staged_file(plan, T, seed=len(name))
    dplan = ir_range._DevicePlan(plan, "cpu")
    fp_t = torch.from_numpy(fp.view(np.int32).copy())
    ext_t = torch.from_numpy(ext.view(np.int32).copy())
    ir_range._run_chunk(dplan, fp_t, ext_t, torch.from_numpy(
        pm.view(np.int32)), T)
    _model(ir_range.encode_plan(plan), fp, ext, pm)
    assert np.array_equal(fp_t.numpy().view(np.uint32), fp)
    assert np.array_equal(ext_t.numpy().view(np.uint32), ext)


def test_cpu_file_runs_the_twin_and_the_wrapper_refuses_it():
    plan = _synthetic_plan()
    po2, before = 2, keval.eval_plan.launches
    rng = np.random.default_rng(4)
    domain = 4 << po2
    evs = tuple(torch.from_numpy(rng.integers(
        0, F.P, (cols, domain), dtype=np.uint32).view(np.int32))
        for cols in (1, 2))
    fn = ir_range.make_eval_check(plan, po2, chunk=8)
    pm = rng.integers(0, F.P, (5, 4), dtype=np.uint32)
    out = fn(evs, np.array([9], np.uint32), pm)
    assert out.shape == (4, domain) and out.device.type == "cpu"
    assert keval.eval_plan.launches == before
    dplan = ir_range._DevicePlan(plan, "cpu")
    fp, ext, pm = (torch.from_numpy(a.view(np.int32))
                   for a in staged_file(plan, 8, seed=1))
    with pytest.raises(ValueError, match="on the card"):
        keval.eval_plan(dplan.ops, dplan.ops_head, fp, ext, pm)
