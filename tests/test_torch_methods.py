"""Public methods that the port's copies had dropped, against the JAX
package on the same inputs: the receipts' ``claim_digest`` and the
layout view's ``len``, ``keys``, iteration, ``repr`` and ``dump``.
tests/test_torch_isolation.py guards every other public name."""

import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEGMENT_SEAL = os.path.join(DATA, "rv32im_seal_po2_14.npy")


def _pkg(name):
    """(receipt module, decode_claim) of the JAX package or the port."""
    if name == "jax":
        from risc0_tpu.circuit.rv32im.claim import decode_claim
        from risc0_tpu.zkvm import receipt
    else:
        from risc0_tpu_torch.circuit.rv32im.claim import decode_claim
        from risc0_tpu_torch.zkvm import receipt
    return receipt, decode_claim


def _succinct(pkg):
    """The golden lift of the po2 14 segment seal in `pkg`'s classes."""
    R, decode_claim = _pkg(pkg)
    meta = np.load(os.path.join(DATA, "recursion_seal_lift14.meta.npz"))
    return R.SuccinctReceipt(
        seal=np.load(os.path.join(DATA, "recursion_seal_lift14.npy")),
        control_id=meta["control_id"],
        claim=decode_claim(np.load(SEGMENT_SEAL)),
        control_root=meta["control_root"],
        control_inclusion_proof={"index": int(meta["incl_index"]),
                                 "digests": meta["incl_digests"]})


def _groth16(pkg):
    """The golden Groth16 receipt in `pkg`'s classes."""
    R, decode_claim = _pkg(pkg)
    z = np.load(os.path.join(DATA, "groth16_receipt_golden.npz"))
    return R.Groth16Receipt(seal=z["seal"].tobytes(),
                            claim=decode_claim(np.load(SEGMENT_SEAL)),
                            verifier_parameters=z["verifier_parameters"])


@pytest.mark.parametrize("kind", ["succinct", "groth16"])
def test_claim_digest_equals_the_jax_one(kind):
    make = _succinct if kind == "succinct" else _groth16
    got, want = make("torch").claim_digest(), make("jax").claim_digest()
    assert np.array_equal(got, want)
    assert np.array_equal(got, make("torch").claim.digest())
    if kind == "groth16":
        z = np.load(os.path.join(DATA, "groth16_receipt_golden.npz"))
        assert np.array_equal(got, z["claim_digest"])


# views of rv32im_global_layout(): the root, a struct, an array, an array
# element, a leaf under "_super" and a plain leaf
_PATHS = ["", "state_in", "state_in.values", "state_in.values.0",
          "state_in.values.0.low", "rng"]


def _view(pkg, path):
    if pkg == "jax":
        from risc0_tpu.circuit.layout import rv32im_global_layout
    else:
        from risc0_tpu_torch.circuit.layout import rv32im_global_layout
    v = rv32im_global_layout()
    for part in filter(None, path.split(".")):
        v = v[int(part)] if part.isdigit() else getattr(v, part)
    return v


def _len(v):
    try:
        return len(v)
    except TypeError as e:
        return f"TypeError: {e}"


@pytest.mark.parametrize("path", _PATHS)
def test_layout_view_methods_equal_the_jax_ones(path):
    got, want = _view("torch", path), _view("jax", path)
    row = (np.arange(90, dtype=np.uint64) * 2654435761 % (1 << 16)).astype(
        np.uint32)
    assert _len(got) == _len(want)
    assert got.keys() == want.keys()
    assert repr(got) == repr(want)
    if isinstance(_len(want), int):
        assert [repr(c) for c in got] == [repr(c) for c in want]
    assert got.dump() == want.dump()
    assert got.dump(row) == want.dump(row)


def test_layout_keys_is_a_method_not_a_field():
    """`__getattr__` reads a missing name as a field: keys must be a
    method of the class, as tests/test_layout.py uses it."""
    from risc0_tpu_torch.circuit.layout import rv32im_global_layout

    g = rv32im_global_layout()
    assert "state_out" in g.keys()
    assert len(g.state_in.values) == 8
    with pytest.raises(AttributeError):
        g.nonexistent_field
