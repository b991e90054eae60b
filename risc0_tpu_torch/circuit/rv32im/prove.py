"""rv32im segment proving on torch: witgen -> generic STARK prover -> seal
(counterpart of ``risc0_tpu/circuit/rv32im/prove.py``).

The seal flow is the reference's (risc0/circuit/rv32im/src/prove/hal/
mod.rs:143-224 prove_core): seal version word, proof-system and circuit
info commits, globals||po2 header, code and data group commits,
Fiat-Shamir mix, accum commit, then the generic DEEP-ALI/FRI finalize.
Exec and accum witness generation run on the host (C++ through
``witgen.py``); everything after runs on `device`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ... import field as F
from ... import perf
from ...convert import card
from ...hash.suite import POSEIDON2
from ...prove.prover import Prover
from ...taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                     REGISTER_GROUP_DATA)
from ...verify import verifier as V
from .. import ir_range
from .circuit import load_circuit
from .verify import RV32IM_SEAL_VERSION
from .witgen import REGCOUNT_MIX, witgen_accum, witgen_exec

# eval_check rows per chunk on an 80 GB card: the register files take
# 8229 x T x 4 B + 3018 x T x 16 B = 5.3 GB at T = 2^16, and 64 chunks
# cover the po2 20 domain
EVAL_CHUNK = 1 << 16


class Rv32imCircuitHal:
    """eval_check through the range-plan evaluator (circuit/ir_range.py),
    chunked over the domain on the device of the evaluated groups."""

    def __init__(self, circuit, chunk: int = EVAL_CHUNK):
        self.circuit = circuit
        self.chunk = chunk
        self.plan = _range_plan(circuit)
        self._fns = {}

    def eval_check(self, groups, globals_list, poly_mix, po2):
        fn = self._fns.get(po2)
        if fn is None:
            fn = self._fns[po2] = ir_range.make_eval_check(
                self.plan, po2, chunk=self.chunk)
        mix_g, out_g = (np.asarray(g, np.uint32) for g in globals_list)
        accum, _code, data = groups
        bufmap = {0: accum, 1: data}
        evs = tuple(bufmap[b] for b in ir_range.plan_buf_ids(self.plan))
        gvals = np.array([(out_g if b == 2 else mix_g)[i]
                          for b, i in self.plan.global_specs], np.uint32)
        return fn(evs, gvals, self.circuit.mix_pows(poly_mix))


@lru_cache(maxsize=None)
def _range_plan(circuit):
    return ir_range.build_range_plan(circuit)


def segment_preflight(seg, rand_z=None, rng=None, device=None):
    """Host half of segment proving: preflight re-execution + exec witness
    generation (reference ProverServer::segment_preflight)."""
    rng = rng or np.random.default_rng()
    if rand_z is None:
        rand_z = tuple(int(x) for x in rng.integers(0, F.P, 4))
    with perf.scope("witgen_exec", sync=device):
        return witgen_exec(seg, rand_z=rand_z)


def prove_segment(seg, rand_z=None, rng=None, device="cuda",
                  eval_chunk: int = EVAL_CHUNK):
    """Prove one executed segment on `device` (the card unless the caller
    names another); returns the seal (u32)."""
    device = card(device)
    res = segment_preflight(seg, rand_z=rand_z, rng=rng, device=device)
    return prove_segment_core(res, device=device, eval_chunk=eval_chunk)


def _info_digest(suite, info: bytes):
    words = np.frombuffer(info.ljust(16, b"\0")[:16], np.uint8)
    return suite.hash_elem_slice(F.encode_np(words.astype(np.uint32)))


def prove_segment_core(res, device="cuda", eval_chunk: int = EVAL_CHUNK):
    """Device half of segment proving over a preflight/witgen result, with
    the accum witness generated on the host (reference
    ProverServer::prove_segment_core with RISC0_TPU_HOST_ACCUM=1)."""
    device = card(device)
    suite = POSEIDON2
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
    iop.commit(_info_digest(suite, V.PROOF_SYSTEM_INFO))
    iop.commit(_info_digest(suite, circuit.CIRCUIT_INFO))

    header = np.concatenate([global_m, np.array([po2], np.uint32)])
    iop.commit(suite.hash_elem_slice(header))
    iop.write_field_elems(header)
    prover.set_po2(po2)

    prover.commit_group(REGISTER_GROUP_CODE, code_m)
    prover.commit_group(REGISTER_GROUP_DATA, res["data"], encode=True)

    mix_m = np.array([iop.random_elem() for _ in range(REGCOUNT_MIX)],
                     np.uint32)
    with perf.scope("witgen_accum", sync=device):
        accum = witgen_accum(res, F.decode_np(mix_m))
    prover.commit_group(REGISTER_GROUP_ACCUM, accum, encode=True)

    hal_obj = Rv32imCircuitHal(circuit, chunk=eval_chunk)
    return prover.finalize([mix_m, global_m], hal_obj)
