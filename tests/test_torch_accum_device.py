"""The port's device accum witgen (risc0_tpu_torch/circuit/rv32im/
accum_device.py) on the CPU against the JAX package, on real executed
segments:

  * the port's graph is the JAX graph node for node, and its plans are
    the JAX plans;
  * witgen_accum_device, decoded, equals the host C++ (the JAX package's
    witgen_accum) on the loop guest's smallest segment (2^14 rows) and on
    the bigint guest, whose accumulator takes the reg0 x reg1 bilinear
    term; against the JAX numpy device algorithm (witgen_accum_np, about
    a minute a segment here) under -m slow;
  * on corrupted witnesses it raises exactly where the C++ rejects;
  * committing its Montgomery words with encode=False gives the Merkle
    layers of the host accum committed with encode=True (16 columns; the
    whole group under -m slow).

Field arithmetic is exact: every comparison is bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from risc0_tpu import field as RF
from risc0_tpu.circuit.rv32im import accum_device as RAD
from risc0_tpu.circuit.rv32im.witgen import witgen_accum, witgen_exec
from risc0_tpu.zkvm.exec import ExecutorEnv, ExecutorImpl
from risc0_tpu_torch.circuit.rv32im import accum_device as AD
from risc0_tpu_torch.convert import to_numpy, to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CPU register file of the `full` plan: 43,580 rows x 2^11 x 4 B = 357 MB
# (the `probe` plan takes all 2^14 rows: 155 MB)
CHUNK = 1 << 11


def _accum(res, mix):
    return AD.witgen_accum_device(res, mix, device="cpu", chunk=CHUNK)


def _loop_res(count=100, seed=3):
    with open(os.path.join(REPO, "guests", "loop.bin"), "rb") as f:
        elf = f.read()
    env = ExecutorEnv(segment_po2=16).write_slice(count.to_bytes(4, "little"))
    seg = ExecutorImpl(env, elf).run().segments[0]
    rng = np.random.default_rng(seed)
    rand_z = tuple(int(x) for x in rng.integers(0, RF.P, 4))
    res = witgen_exec(seg, rand_z=rand_z)
    return res, rng.integers(0, RF.P, 36).astype(np.uint32)


@pytest.fixture(scope="module")
def loop():
    res, mix = _loop_res()
    assert res["rows"] == 1 << 14
    return res, mix, _accum(res, mix)


@pytest.fixture(scope="module")
def bigint():
    from tests.test_bigint import test_bigint2_guest_executes

    executed = test_bigint2_guest_executes()
    res = witgen_exec(executed.segments[0], rand_z=(5, 6, 7, 8))
    mix = np.arange(1, 37, dtype=np.uint32)
    # the witness as a tensor, as the device exec hands it over
    return res, mix, _accum(dict(res, data=to_torch(res["data"])), mix)


def test_graph_is_the_jax_graph():
    ag, rg = AD.accum_graph(), RAD.accum_graph()
    assert ag.g.nodes == rg.g.nodes
    assert ag.g.domain == rg.g.domain
    assert (ag.out_cols, ag.bad) == (rg.out_cols, rg.bad)
    assert (ag.data_taps, ag.glob_ids, ag.mix_ids) == \
        (rg.data_taps, rg.glob_ids, rg.mix_ids)


@pytest.mark.parametrize("name", ["probe", "full"])
def test_plan_is_the_jax_plan(name):
    got, want = AD._plans()[name], RAD._plans()[name]
    for attr in ("n_rows", "tap_start", "scal_start", "state_start"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("const_vals", "tap_sel", "scal_sel", "state_sel",
                 "out_rows"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert len(got.groups) == len(want.groups)
    for (k, d, n, o), (rk, rd, rn, ro) in zip(got.groups, want.groups):
        assert (k, d, n) == (rk, rd, rn)
        assert all(np.array_equal(a, b) for a, b in zip(o, ro))


def _assert_equal(got_m, want):
    got = RF.decode_np(to_numpy(got_m))
    mism = np.argwhere(got != want)
    assert mism.size == 0, \
        f"{len(mism)} mismatching cells, first: {mism[:5].tolist()}"


def test_accum_device_matches_cpp_loop(loop):
    res, mix, got = loop
    assert got.dtype == torch.int32 and tuple(got.shape) == (103, 1 << 14)
    _assert_equal(got, witgen_accum(res, mix))


def test_accum_device_matches_cpp_bigint(bigint):
    res, mix, got = bigint
    _assert_equal(got, witgen_accum(res, mix))


@pytest.mark.slow
def test_accum_device_matches_jax_numpy_loop(loop):
    res, mix, got = loop
    _assert_equal(got, RAD.witgen_accum_np(res, mix))


@pytest.mark.slow
def test_accum_device_matches_jax_numpy_bigint(bigint):
    res, mix, got = bigint
    _assert_equal(got, RAD.witgen_accum_np(res, mix))


def test_corrupt_witness_accepted_by_cpp_gives_its_accum():
    # tests/test_accum_device.py's corruption (64 data registers of one
    # row set to 2): the accum pass checks no constraint it breaks, so the
    # C++ accepts it and the port must give the C++ accum
    res, mix = _loop_res(count=30)
    data = res["data"].copy()
    data[:64, res["rows"] // 2] = 2
    res = dict(res, data=data)
    _assert_equal(_accum(res, mix), witgen_accum(res, mix))


def test_corrupt_selector_rejected_by_cpp_is_rejected():
    # a one-hot selector cleared in a lookup-table row: the C++ hits an
    # unreachable mux arm, and the port's bad-row mask must count it
    res, mix = _loop_res(count=30)
    row = res["rows"] - 3
    for col in np.nonzero(res["data"][:, row] == 1)[0]:
        data = res["data"].copy()
        data[col, row] = 0
        try:
            witgen_accum(dict(res, data=data), mix)
        except RuntimeError:
            break
    else:
        pytest.fail(f"no cleared selector of row {row} rejected by the C++")
    with pytest.raises(RuntimeError, match="1 rows failed in-circuit checks"):
        _accum(dict(res, data=data), mix)


# one Poseidon2 block a row in tier-1; the whole accum group is slow here
@pytest.mark.parametrize("cols",
                         [16, pytest.param(103, marks=pytest.mark.slow)])
def test_device_accum_commit_equals_host_accum_commit(loop, cols):
    from risc0_tpu_torch.hal import torch_hal as hal

    res, mix, got = loop
    host = witgen_accum(res, mix)[:cols]
    _c1, _e1, want = hal.commit_pipeline(host, encode=True, device="cpu")
    _c2, _e2, layers = hal.commit_pipeline(got[:cols], encode=False,
                                           device="cpu")
    assert len(layers) == len(want)
    for a, b in zip(layers, want):
        assert torch.equal(a, b)


def test_failing_device_accum_raises_and_never_runs_the_host(monkeypatch):
    from risc0_tpu_torch.circuit.rv32im import prove

    res, _mix = _loop_res(count=30)

    def device_accum(res, mix, device):
        raise RuntimeError("accum device eval: 1 rows failed in-circuit "
                           "checks")

    def host_accum(*a, **k):
        raise AssertionError("the host accum ran")

    # the commits are not under test: skip their work
    monkeypatch.setattr(prove.Prover, "commit_group", lambda *a, **k: None)
    monkeypatch.setattr(prove, "witgen_accum_device", device_accum)
    monkeypatch.setattr(prove, "witgen_accum", host_accum)
    with pytest.raises(RuntimeError, match="failed in-circuit checks"):
        prove.prove_segment_core(res, device="cpu")
