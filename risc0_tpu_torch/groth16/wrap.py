"""Builtin stark-to-snark wrap: identity_p254 seal -> Groth16Receipt,
fully in-process on the host (counterpart of ``risc0_tpu/groth16/wrap.py``).

The reference's equivalent chain is identity_p254 -> seal_to_json ->
circom witness generator -> rapidsnark, all inside a docker image
(risc0/groth16/src/prove/docker.rs:34-75) against the ceremony CRS.  Here
the stark_verify R1CS is built by groth16/stark_verify.py and proved with
groth16/prove.py; the CRS is generated on first use (single-party dev
ceremony) and cached on disk, and receipts carry the generated verifying
key through Groth16ReceiptVerifierParameters.verifying_key.

CRS cache location: $RISC0_TPU_CRS_DIR or ~/.cache/risc0_tpu/.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from . import native as nat
from .prove import ProvingKey, prove, setup
from .stark_verify import StarkVerifyBuilder
from .verifier import VerifyingKey, proof_json_to_seal

_LOCK = threading.Lock()
_CACHED: tuple | None = None  # (pk, vk)


def crs_dir() -> str:
    return os.environ.get(
        "RISC0_TPU_CRS_DIR", os.path.expanduser("~/.cache/risc0_tpu"))


def _pk_path() -> str:
    return os.path.join(crs_dir(), "groth16_stark_verify_pk.npz")


def _vk_path() -> str:
    return os.path.join(crs_dir(), "groth16_stark_verify_vk.npz")


def _save_vk(vk: VerifyingKey, path: str):
    np.savez(path,
             alpha_g1=nat.g1_arr([vk.alpha_g1]),
             beta_g2=nat.g2_arr([vk.beta_g2]),
             gamma_g2=nat.g2_arr([vk.gamma_g2]),
             delta_g2=nat.g2_arr([vk.delta_g2]),
             ic=nat.g1_arr(vk.ic))


def _load_vk(path: str) -> VerifyingKey:
    z = np.load(path)
    return VerifyingKey(
        alpha_g1=nat.g1_from_arr(z["alpha_g1"])[0],
        beta_g2=nat.g2_from_arr(z["beta_g2"])[0],
        gamma_g2=nat.g2_from_arr(z["gamma_g2"])[0],
        delta_g2=nat.g2_from_arr(z["delta_g2"])[0],
        ic=nat.g1_from_arr(z["ic"]))


def build_circuit(seal, check: bool = False) -> StarkVerifyBuilder:
    """stark_verify circuit over an identity_p254 recursion seal (default
    recursion circuit + public-input binding)."""
    return StarkVerifyBuilder(np.asarray(seal, np.uint32), check=check)


def ensure_crs(circuit: StarkVerifyBuilder, n_threads: int = 0):
    """Load (or generate and cache) the CRS matching this circuit."""
    global _CACHED
    with _LOCK:
        if _CACHED is not None and _CACHED[0].structure == \
                circuit.cs.structure_digest():
            return _CACHED
        os.makedirs(crs_dir(), exist_ok=True)
        if os.path.exists(_pk_path()) and os.path.exists(_vk_path()):
            pk = ProvingKey.load(_pk_path())
            if pk.structure == circuit.cs.structure_digest():
                vk = _load_vk(_vk_path())
                pk.coo = circuit.cs.coo()
                _CACHED = (pk, vk)
                return _CACHED
        pk, vk = setup(circuit.cs, n_threads=n_threads)
        pk.save(_pk_path())
        _save_vk(vk, _vk_path())
        _CACHED = (pk, vk)
        return _CACHED


def verifier_parameters(vk: VerifyingKey | None = None):
    """Groth16ReceiptVerifierParameters bound to the builtin CRS vk (loads
    the cached vk when not given); None when no CRS exists yet."""
    from ..zkvm.receipt import Groth16ReceiptVerifierParameters

    if vk is None:
        if _CACHED is not None:
            vk = _CACHED[1]
        elif os.path.exists(_vk_path()):
            vk = _load_vk(_vk_path())
        else:
            return None
    params = Groth16ReceiptVerifierParameters.default()
    params.verifying_key = vk
    return params


def wrap(p254_receipt, n_threads: int = 0):
    """identity_p254 SuccinctReceipt -> (Groth16Receipt, params)."""
    from ..zkvm.receipt import Groth16Receipt

    circuit = build_circuit(p254_receipt.seal)
    pk, vk = ensure_crs(circuit, n_threads=n_threads)
    proof = prove(pk, circuit.cs, n_threads=n_threads)
    seal = proof_json_to_seal(proof)
    params = verifier_parameters(vk)
    receipt = Groth16Receipt(seal=seal, claim=p254_receipt.claim,
                             verifier_parameters=params.digest())
    return receipt, params
