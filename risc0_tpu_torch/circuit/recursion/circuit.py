"""Recursion circuit: the PolyExtStep interpreter, seal verification and
the prover-side circuit (counterpart of
``risc0_tpu/circuit/recursion/circuit.py``).

Reference parity: risc0/circuit/recursion/src/{taps.rs,poly_ext.rs,
info.rs}; interpreter semantics risc0/zkp/src/adapter.rs:152-401.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ... import field as F
from ...assets import RECURSION_DATA as _DATA
from ..rv32im.circuit import Rv32imCircuit, _taps_to_tapset

CIRCUIT_INFO = b"RECURSION:rev1v1"  # reference recursion/src/info.rs:23
OUTPUT_SIZE = 32
MIX_SIZE = 20
RECURSION_PO2 = 18  # reference zkvm/src/host/recursion/prove/mod.rs:58

CONST, CONSTEXT, GET, GETGLOBAL, ADD, SUB, MUL, TRUE, ANDEQZ, ANDCOND = range(10)


class RecursionCircuit:
    def __init__(self, taps, opcode, operands, ret):
        self.taps = taps
        self.CIRCUIT_INFO = CIRCUIT_INFO
        self.OUTPUT_SIZE = OUTPUT_SIZE
        self.MIX_SIZE = MIX_SIZE
        self.opcode = opcode
        self.operands = operands
        self.ret = int(ret)

    def poly_ext(self, poly_mix, eval_u, out, mix):
        """PolyExtStep executor (adapter.rs:327-401); returns MixState.tot.
        poly_mix (4,) and eval_u (num_taps, 4) are ext Montgomery words,
        out (32,) and mix (20,) base Montgomery words.  The 12k steps run
        over python-int 4-tuples (numpy's per-call cost dominates at this
        size)."""
        pmix = _ext(poly_mix)
        eval_u = [_ext(e) for e in np.asarray(eval_u, np.uint32)]
        args = [[int(w) for w in np.asarray(a, np.uint32)] for a in (out, mix)]
        zero, one = (0, 0, 0, 0), (F.MONT_ONE, 0, 0, 0)

        fp_vars = []
        mix_vars = []  # list of (tot, mul)
        for op, row in zip(self.opcode.tolist(), self.operands.tolist()):
            a, b, c, d = row
            if op == CONST:
                fp_vars.append((F.s_encode(a % F.P), 0, 0, 0))
            elif op == CONSTEXT:
                fp_vars.append(tuple(F.s_encode(v % F.P) for v in row))
            elif op == GET:
                fp_vars.append(eval_u[a])
            elif op == GETGLOBAL:
                fp_vars.append((args[a][b], 0, 0, 0))
            elif op == ADD:
                fp_vars.append(_eadd(fp_vars[a], fp_vars[b]))
            elif op == SUB:
                fp_vars.append(_esub(fp_vars[a], fp_vars[b]))
            elif op == MUL:
                fp_vars.append(_emul(fp_vars[a], fp_vars[b]))
            elif op == TRUE:
                mix_vars.append((zero, one))
            elif op == ANDEQZ:
                tot, mul = mix_vars[a]
                mix_vars.append((_eadd(tot, _emul(mul, fp_vars[b])),
                                 _emul(mul, pmix)))
            elif op == ANDCOND:
                tot, mul = mix_vars[a]
                itot, imul = mix_vars[c]
                mix_vars.append((_eadd(tot, _emul(_emul(fp_vars[b], itot),
                                                  mul)),
                                 _emul(mul, imul)))
            else:
                raise ValueError(f"bad opcode {op}")
        return np.array(mix_vars[self.ret][0], np.uint32)


def _ext(v):
    return tuple(int(w) for w in np.asarray(v, np.uint32))


def _eadd(a, b):
    return tuple((x + y) % F.P for x, y in zip(a, b))


def _esub(a, b):
    return tuple((x - y) % F.P for x, y in zip(a, b))


def _emul(a, b):
    """F_p4 product of Montgomery words (x^4 = -BETA): the raw sums carry
    R^2, one R^-1 each restores Montgomery form."""
    p, nb, ri = F.P, F.NBETA, F.R_INV
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return ((a0 * b0 + nb * (a1 * b3 + a2 * b2 + a3 * b1)) % p * ri % p,
            (a0 * b1 + a1 * b0 + nb * (a2 * b3 + a3 * b2)) % p * ri % p,
            (a0 * b2 + a1 * b1 + a2 * b0 + nb * a3 * b3) % p * ri % p,
            (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % p * ri % p)


def _tapset():
    return _taps_to_tapset(np.load(os.path.join(_DATA, "taps.npz")))


@lru_cache(maxsize=1)
def load_circuit() -> RecursionCircuit:
    """Verifier-side circuit: taps + the PolyExtStep bytecode."""
    pe = np.load(os.path.join(_DATA, "poly_ext.npz"))
    return RecursionCircuit(_tapset(), pe["opcode"], pe["operands"],
                            pe["ret"])


def verify_recursion_seal(seal, check_control_id=None,
                          suite=None) -> np.ndarray:
    """Verify a recursion-circuit seal (the inner check of SuccinctReceipt
    verification, reference receipt/succinct.rs:103-190) under `suite`
    (default Poseidon2; Poseidon254 for identity_p254 receipts); returns
    the 32 output globals.  `check_control_id` receives (po2, code_root)
    and raises if the program is not allowed."""
    from ...hash.suite import POSEIDON2
    from ...verify import verifier as V

    return V.verify(load_circuit(), suite or POSEIDON2,
                    np.asarray(seal, np.uint32),
                    check_control_id or (lambda po2, root: None))


@lru_cache(maxsize=1)
def load_prover_circuit() -> Rv32imCircuit:
    """Prover-side circuit: taps + the constraint-poly IR (extracted from
    the generated poly_fp.cpp) in the shared Rv32imCircuit machinery, which
    ``circuit/ir_range.py`` evaluates over the domain."""
    ir = np.load(os.path.join(_DATA, "poly_fp_ir.npz"), allow_pickle=True)
    c = Rv32imCircuit(
        _tapset(), ir["opcode"], ir["operands"], ir["n_f"], ir["n_e"],
        ir["fscr_size"], ir["escr_size"], ir["ret"],
        ir["mix_powers"] if "mix_powers" in ir.files else None)
    c.CIRCUIT_INFO = CIRCUIT_INFO
    c.OUTPUT_SIZE = OUTPUT_SIZE
    c.MIX_SIZE = MIX_SIZE
    return c
