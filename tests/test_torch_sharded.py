"""The port's sharded commit over a list of devices, on the CPU.

A mesh may name one device more than once, so lists of 2, 4 and 8 CPU
devices drive every branch of the mesh path here:

  * commit_sharded of a (211, 2^12) seeded witness (the rv32im data
    group's width) equals commit_pipeline, coefficients, evaluations and
    every Merkle layer;
  * the fib prove at po2 6, seed 0, under mesh_context is the JAX
    package's seal (tests/data/fib_seal_po2_6_seed_0.npy), verifies, and
    went through the sharded commit;
  * the rv32im eval_check under a mesh equals the one-device run at po2 4
    (the counterpart of tests/test_sharded.py's), and a chunk count the
    mesh does not divide is refused;
  * mesh_context restores the previous state, after an exception too;
  * a pipeline asked for a device other than the mesh's first raises.
"""

import os

import numpy as np
import pytest
import torch

from risc0_tpu_torch import field as F
from risc0_tpu_torch.convert import to_torch
from risc0_tpu_torch.hal import torch_hal as hal
from risc0_tpu_torch.parallel.sharded import commit_sharded, mesh_context

torch.set_num_threads(2)

MESHES = [2, 4, 8]
FIB_SEAL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "fib_seal_po2_6_seed_0.npy")


@pytest.fixture(scope="module")
def witness_and_commit():
    rng = np.random.default_rng(3)
    witness = rng.integers(0, F.P, size=(211, 1 << 12), dtype=np.uint32)
    return witness, hal.commit_pipeline(witness, device="cpu")


@pytest.mark.parametrize("k", MESHES)
def test_sharded_commit_equals_one_device(witness_and_commit, k):
    witness, (cn1, ev1, layers1) = witness_and_commit
    cn2, ev2, layers2 = commit_sharded(witness, ["cpu"] * k)
    assert torch.equal(cn1, cn2)
    assert torch.equal(ev1, ev2)
    assert len(layers1) == len(layers2) == 15
    for a, b in zip(layers1, layers2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_fib_prove_is_the_jax_seal(monkeypatch, k):
    from risc0_tpu_torch.circuit import fib

    calls = []
    sharded = hal._sharded

    def spy(x, lde, devs):
        calls.append(x.shape)
        return sharded(x, lde, devs)

    monkeypatch.setattr(hal, "_sharded", spy)
    with mesh_context(["cpu"] * k):
        seal = fib.prove(po2=6, seed=0, device="cpu")
    assert np.array_equal(seal, np.load(FIB_SEAL))
    fib.verify(seal, device="cpu")
    # the code, data and accum groups and the check group
    assert len(calls) == 4


@pytest.fixture(scope="module")
def eval_check_inputs():
    from risc0_tpu_torch.circuit import ir_range
    from risc0_tpu_torch.circuit.rv32im.circuit import load_circuit

    c = load_circuit()
    po2 = 4
    domain = (1 << po2) * 4
    rng = np.random.default_rng(11)
    accum = rng.integers(0, F.P, (103, domain), dtype=np.uint32)
    data = rng.integers(0, F.P, (211, domain), dtype=np.uint32)
    mix = rng.integers(0, F.P, 36, dtype=np.uint32)
    out = rng.integers(0, F.P, 90, dtype=np.uint32)
    pm = rng.integers(0, F.P, 4, dtype=np.uint32)
    plan = ir_range.build_range_plan(c)
    assert ir_range.plan_buf_ids(plan) == [0, 1]
    gvals = np.array([(out if b == 2 else mix)[i]
                      for b, i in plan.global_specs], np.uint32)
    fn = ir_range.make_eval_check(plan, po2, chunk=8)
    args = ((to_torch(accum), to_torch(data)), gvals, c.mix_pows(pm))
    return fn, args, fn(*args)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_eval_check_equals_one_device(eval_check_inputs, k):
    fn, args, want = eval_check_inputs
    with mesh_context(["cpu"] * k):
        got = fn(*args)
    assert torch.equal(got, want)


def test_sharded_eval_check_needs_an_even_split(eval_check_inputs):
    fn, args, _want = eval_check_inputs
    with mesh_context(["cpu"] * 3):   # 8 chunks over 3 devices
        with pytest.raises(ValueError, match="not divisible"):
            fn(*args)


def test_mesh_context_restores_state():
    assert hal.mesh() is None
    with mesh_context(["cpu", "cpu"]) as devs:
        assert hal.mesh() == devs == [torch.device("cpu")] * 2
        with mesh_context(["cpu"] * 4):
            assert len(hal.mesh()) == 4
        assert hal.mesh() == devs
    assert hal.mesh() is None
    with pytest.raises(KeyError):
        with mesh_context(["cpu"] * 2):
            raise KeyError("inside the mesh")
    assert hal.mesh() is None


def test_sharded_commit_refuses_a_device_count_not_a_power_of_two():
    w = np.zeros((4, 1 << 6), np.uint32)
    with pytest.raises(ValueError, match="power of two"):
        commit_sharded(w, ["cpu"] * 3)
    assert hal.mesh() is None


def test_pipeline_refuses_a_device_off_the_mesh():
    w = np.zeros((4, 1 << 6), np.uint32)
    with mesh_context(["cpu"] * 2):
        with pytest.raises(ValueError, match="not the first device"):
            hal.commit_pipeline(w, device="meta")
        with pytest.raises(ValueError, match="not the first device"):
            hal.check_pipeline(torch.zeros((4, 1 << 6), dtype=torch.int32,
                                           device="meta"))
