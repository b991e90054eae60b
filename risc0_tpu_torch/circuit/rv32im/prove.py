"""rv32im segment proving on torch: witgen -> generic STARK prover -> seal
(counterpart of ``risc0_tpu/circuit/rv32im/prove.py``).

The seal flow is the reference's (risc0/circuit/rv32im/src/prove/hal/
mod.rs:143-224 prove_core): seal version word, proof-system and circuit
info commits, globals||po2 header, code and data group commits,
Fiat-Shamir mix, accum commit, then the generic DEEP-ALI/FRI finalize.

The accum witness is generated on `device` (``accum_device.py``), as in the
reference; ``accum="host"`` runs the host C++ instead (``witgen.py``), for
diagnostics and A/B checks.  The exec witness is generated on the host by
default, as in the reference; ``exec="device"`` generates it on `device`
(``exec_device.py``), where the data matrix stays for its commit and the
device accum.  Everything else runs on `device`.
"""

from __future__ import annotations

import numpy as np

from ... import field as F
from ... import perf, telemetry
from ...convert import card, to_numpy
from ...hash.suite import POSEIDON2
from ...prove.prover import Prover
from ...taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                     REGISTER_GROUP_DATA)
from ...verify import verifier as V
from .. import ir_range
from .accum_device import witgen_accum_device
from .circuit import load_circuit
from .exec_device import witgen_exec_device
from .verify import RV32IM_SEAL_VERSION
from .witgen import REGCOUNT_MIX, witgen_accum, witgen_exec

# eval_check rows per chunk on an 80 GB card: the register files take
# 8229 x T x 4 B + 3018 x T x 16 B = 5.3 GB at T = 2^16, and 64 chunks
# cover the po2 20 domain
EVAL_CHUNK = 1 << 16


def segment_preflight(seg, rand_z=None, rng=None, device="cuda",
                      exec: str = "host"):
    """First half of segment proving: preflight re-execution + exec witness
    generation (reference ProverServer::segment_preflight), by the host C++
    (exec="host") or on `device` (exec="device"), the card unless the
    caller names another."""
    device = card(device)
    if exec not in ("host", "device"):
        raise ValueError(f"exec={exec!r}: 'host' or 'device'")
    rng = rng or np.random.default_rng()
    if rand_z is None:
        rand_z = tuple(int(x) for x in rng.integers(0, F.P, 4))
    with perf.scope("witgen_exec", sync=device):
        if exec == "device":
            return witgen_exec_device(seg, rand_z=rand_z, device=device)
        return witgen_exec(seg, rand_z=rand_z)


def prove_segment(seg, rand_z=None, rng=None, device="cuda",
                  eval_chunk: int = EVAL_CHUNK, exec: str = "host",
                  accum: str = "device", suite=None):
    """Prove one executed segment on `device` (the card unless the caller
    names another) under `suite` (default Poseidon2); returns the seal
    (u32).  exec and accum say where each witness is generated: "host"
    (C++) or "device"."""
    device = card(device)
    with telemetry.boundary("prove_segment") as sp:
        res = segment_preflight(seg, rand_z=rand_z, rng=rng, device=device,
                                exec=exec)
        sp.set(po2=int(res["rows"]).bit_length() - 1)
        return prove_segment_core(res, device=device, eval_chunk=eval_chunk,
                                  accum=accum, suite=suite)


def _info_digest(suite, info: bytes):
    words = np.frombuffer(info.ljust(16, b"\0")[:16], np.uint8)
    return suite.hash_elem_slice(F.encode_np(words.astype(np.uint32)))


def open_seal(prover, suite, circuit_info: bytes, global_m, po2: int):
    """The seal's opening after any version word (reference prove_core):
    the proof-system and circuit info commits, then the globals||po2
    header, committed and written; sets the prover's po2."""
    iop = prover.iop
    iop.commit(_info_digest(suite, V.PROOF_SYSTEM_INFO))
    iop.commit(_info_digest(suite, circuit_info))
    header = np.concatenate([global_m, np.array([po2], np.uint32)])
    iop.commit(suite.hash_elem_slice(header))
    iop.write_field_elems(header)
    prover.set_po2(po2)


def prove_segment_core(res, device="cuda", eval_chunk: int = EVAL_CHUNK,
                       accum: str = "device", suite=None):
    """Device half of segment proving over a preflight/witgen result
    (reference ProverServer::prove_segment_core).  The accum witness is
    generated on `device` (accum="device", the reference's default) or by
    the host C++ (accum="host"); a failing device accum raises."""
    device = card(device)
    if accum not in ("host", "device"):
        raise ValueError(f"accum={accum!r}: 'host' or 'device'")
    suite = suite or POSEIDON2
    circuit = load_circuit()
    cycles = res["rows"]
    po2 = cycles.bit_length() - 1
    if 1 << po2 != cycles:
        raise ValueError(f"segment rows {cycles} is not a power of two")

    with perf.scope("encode_host"):
        # only the 90 globals encode on the host (the header needs them);
        # the data and accum matrices encode on the device in the commit
        global_m = F.encode_np(res["global"])
        code_m = np.zeros((1, cycles), np.uint32)  # zeroized code group

    prover = Prover(suite, circuit.taps, device)
    iop = prover.iop
    iop.write_u32s([RV32IM_SEAL_VERSION])
    open_seal(prover, suite, circuit.CIRCUIT_INFO, global_m, po2)

    prover.commit_group(REGISTER_GROUP_CODE, code_m)
    prover.commit_group(REGISTER_GROUP_DATA, res["data"], encode=True)

    mix_m = np.array([iop.random_elem() for _ in range(REGCOUNT_MIX)],
                     np.uint32)
    mix = F.decode_np(mix_m)
    with perf.scope("witgen_accum", sync=device):
        if accum == "device":
            # Montgomery words: the commit skips its encode pass
            accum_w = witgen_accum_device(res, mix, device=device)
        else:
            accum_w = witgen_accum(dict(res, data=to_numpy(res["data"])), mix)
    prover.commit_group(REGISTER_GROUP_ACCUM, accum_w,
                        encode=accum == "host")

    hal_obj = ir_range.RangePlanHal(circuit, chunk=eval_chunk)
    return prover.finalize([mix_m, global_m], hal_obj)
