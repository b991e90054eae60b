"""The port's device exec witgen (risc0_tpu_torch/circuit/rv32im/
exec_device.py) on the CPU against the JAX package:

  * the port's graph and two plans are the JAX ones;
  * witgen_exec_device gives the data, global and lookup tables of the
    host C++ (the JAX package's witgen_exec) on the loop guest's smallest
    segment (2^14 rows), the sha guest (the accelerator's deep back-reads)
    and a PoVW-nonce run; against the JAX numpy device algorithm
    (witgen_exec_np) under -m slow;
  * it raises on a corrupted trace that the C++ rejects;
  * the u32 kinds (IADD, SHRI, MODU, PAIR16, the rv32im divide) on int32
    storage equal numpy u32 and the JAX package's _divide_np at the edge
    words, over all three divide signs;
  * prove_segment(exec="device") raises when the device exec fails and
    never runs the host C++ instead.

Every comparison is exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

from risc0_tpu.circuit.rv32im import exec_device as RED
from risc0_tpu.circuit.rv32im.witgen import witgen_exec
from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl, preflight_segment
from risc0_tpu_torch.circuit.rv32im import exec_device as ED
from risc0_tpu_torch.convert import to_numpy, to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAND_Z = (5, 6, 7, 8)
# CPU register file of pass 2: 57,112 rows x 2^11 x 4 B = 468 MB (pass 1
# takes all 2^14 rows: 532 MB)
P2_CHUNK = 1 << 11


def _exec(seg, pf=None):
    return ED.witgen_exec_device(seg, rand_z=RAND_Z, pf=pf, device="cpu",
                                 p2_chunk=P2_CHUNK)


def _loop_segment(count=100, **env_kw):
    with open(os.path.join(REPO, "guests", "loop.bin"), "rb") as f:
        elf = f.read()
    env = ExecutorEnv(segment_po2=16, **env_kw).write_slice(
        count.to_bytes(4, "little"))
    return ExecutorImpl(env, elf).run().segments[0]


def _sha_segment():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from sha import build_guest

    msg = b"exec-device sha conformance vector " * 3
    env = ExecutorEnv(segment_po2=16).write_slice(msg)
    return ExecutorImpl(env, build_guest(len(msg))).run().segments[0]


def _povw_segment():
    from risc0_tpu.zkvm.povw import PovwJobId

    job = PovwJobId(log=0xABCDEF0123456789ABCDEF0123456789ABCDEF01,
                    job=0x1122334455667788)
    return _loop_segment(60, povw_job_id=job)


SEGMENTS = {"loop": _loop_segment, "sha": _sha_segment,
            "povw": _povw_segment}


def test_graph_is_the_jax_graph():
    eg, rg = ED.exec_graph(), RED.exec_graph()
    assert eg.g.nodes == rg.g.nodes
    assert eg.g.domain == rg.g.domain
    for attr in ("data_cols", "glob_sites", "delta_sites", "bad",
                 "init_cols", "roll_specs", "first_current_pc"):
        assert getattr(eg, attr) == getattr(rg, attr), attr


@pytest.mark.parametrize("name", ["p1", "p2"])
def test_plan_is_the_jax_plan(name):
    got, want = ED._plans_exec()[1][name], RED._plans_exec()[1][name]
    for attr in ("n_rows", "cyc_start", "cyc_fields", "rowidx_row",
                 "glob_start", "glob_cols", "init_start", "init_specs"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("const_vals", "out_rows"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert len(got.init_groups) == len(want.init_groups)
    for (b, c, s), (rb, rc, rs) in zip(got.init_groups, want.init_groups):
        assert (b, s) == (rb, rs) and np.array_equal(c, rc)
    assert len(got.groups) == len(want.groups)
    for (k, d, n, o, i), (rk, rd, rn, ro, ri) in zip(got.groups, want.groups):
        assert (k, d, n) == (rk, rd, rn) and np.array_equal(i, ri)
        assert all(np.array_equal(a, b) for a, b in zip(o, ro))


def _assert_same(got, want):
    assert got["rows"] == want["rows"]
    data = to_numpy(got["data"])
    mis = np.argwhere(data != want["data"])
    assert mis.size == 0, \
        f"{len(mis)} mismatching data cells, first {mis[:5].tolist()}"
    for key in ("global", "tables_u8", "tables_u16"):
        assert got[key].dtype == np.uint32, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_exec_device_matches_cpp(name):
    seg = SEGMENTS[name]()
    got = _exec(seg)
    assert got["data"].dtype == torch.int32
    _assert_same(got, witgen_exec(seg, rand_z=RAND_Z))


@pytest.mark.slow
def test_exec_device_matches_jax_numpy():
    seg = _loop_segment()
    _assert_same(_exec(seg), RED.witgen_exec_np(seg, rand_z=RAND_Z))


def test_exec_device_rejects_trace_the_cpp_rejects():
    # tests/test_exec_device.py's corruption: a major selector flipped in
    # a body row
    seg = _loop_segment(30)
    pf = dict(preflight_segment(seg))
    cyc = pf["cycles"].copy()
    cyc[len(cyc) // 4, 2] ^= 1
    pf["cycles"] = cyc
    with pytest.raises(RuntimeError):
        witgen_exec(seg, rand_z=RAND_Z, pf=dict(pf))
    with pytest.raises(RuntimeError, match="failed in-circuit checks"):
        _exec(seg, pf=dict(pf))


# u32 words at the edges of int32 storage
EDGE = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)


def _pairs():
    a, b = np.meshgrid(EDGE, EDGE, indexing="ij")
    return a.reshape(1, -1), b.reshape(1, -1)   # (n = 1 member, T = 25)


def _kind(kind, *ops, imm=0):
    ops_t = torch.stack([to_torch(o) for o in ops])
    imm_t = torch.full((ops[0].shape[0], 1), imm, dtype=torch.int64)
    return to_numpy(ED._exec_compute(kind, ops_t, imm_t, {}))


def test_u32_kinds_at_edge_words():
    a, b = _pairs()
    assert np.array_equal(_kind(ED.IADD, a, b), a + b)
    assert np.array_equal(_kind(ED.EQU, a, b), (a == b).astype(np.uint32))
    assert np.array_equal(_kind(ED.BAND, a, b), a & b)
    with np.errstate(divide="ignore"):
        modu = np.where(b != 0, a % np.maximum(b, 1), 0).astype(np.uint32)
    assert np.array_equal(_kind(ED.MODU, a, b), modu)
    assert np.array_equal(_kind(ED.PAIR16, a, b), a | (b << np.uint32(16)))
    for shift in (1, 16, 31):
        assert np.array_equal(_kind(ED.SHRI, a, imm=shift),
                              a >> np.uint32(shift))
    lo, x, hi = np.meshgrid(EDGE, EDGE, EDGE, indexing="ij")
    lo, x, hi = (v.reshape(1, -1) for v in (lo, x, hi))
    assert np.array_equal(_kind(ED.INRANGE, lo, x, hi),
                          ((lo <= x) & (x < hi)).astype(np.uint32))


@pytest.mark.parametrize("sign", [0, 1, 2])
def test_divide_at_edge_words(sign):
    a, b = _pairs()
    s = np.full_like(a, sign)
    want_q, want_r = RED._divide_np(a, b, s)
    assert np.array_equal(_kind(ED.XDIVQ, a, b, s), want_q)
    assert np.array_equal(_kind(ED.XDIVR, a, b, s), want_r)


def test_failing_device_exec_raises_and_never_runs_the_host(monkeypatch):
    from risc0_tpu_torch.circuit.rv32im import prove

    def device_exec(seg, rand_z, device):
        raise RuntimeError("exec device eval: 1 rows failed in-circuit "
                           "checks")

    def host_exec(*a, **k):
        raise AssertionError("the host exec ran")

    monkeypatch.setattr(prove, "witgen_exec_device", device_exec)
    monkeypatch.setattr(prove, "witgen_exec", host_exec)
    with pytest.raises(RuntimeError, match="failed in-circuit checks"):
        prove.prove_segment(None, rand_z=RAND_Z, device="cpu", exec="device")
