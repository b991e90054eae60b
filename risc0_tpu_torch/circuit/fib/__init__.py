"""Fibonacci AIR on the torch prover (counterpart of
``risc0_tpu/circuit/fib/__init__.py``).

The same three-group circuit (accum/code/data), the same witness from the
same seed, and the same seal word for word; only ``eval_check`` is new
(plain torch on the prover's device).  The host witness generation and the
verifier-side ``poly_ext`` are the reference's, re-pointed at this
package's field.

Constraints (tot = sum_i poly_mix^i * C_i):
  C0: s0   * (x - f0)
  C1: s1   * (x - f1)
  C2: rec  * (x - x@1 - x@2)
  C3: fini * (x - f_last)
  C4: (s0 + s1 + rec + fini) * (a - mix0 * x)
"""

from __future__ import annotations

import numpy as np
import torch

from ... import field as F
from ...convert import card
from ...core import poly
from ...hal import torch_hal as hal
from ...hash.suite import POSEIDON2
from ...prove.prover import PolyGroup, Prover
from ...taps import (REGISTER_GROUP_ACCUM, REGISTER_GROUP_CODE,
                     REGISTER_GROUP_DATA, TapSet)
from ...verify import verifier as V

SEAL_VERSION = 1
CIRCUIT_INFO = b"fib-tpu:v1______"
OUTPUT_SIZE = 3
MIX_SIZE = 4
NUM_CONSTRAINTS = 5
INV_RATE = 4

TAPS = TapSet.from_backs(
    ("accum", "code", "data"),
    [
        [[0]],                      # accum: a
        [[0], [0], [0], [0]],       # code: s0, s1, rec, fini
        [[0, 1, 2]],                # data: x
    ],
)


def _zk_rows(cycles: int) -> int:
    """Blinding rows (the reference uses ZK_CYCLES=1024 at po2>=13)."""
    return min(1024, cycles // 4)


def witgen(po2: int, f0: int = 1, f1: int = 1, seed: int | None = None):
    """Code/data witnesses + globals (host, Montgomery form)."""
    cycles = 1 << po2
    active = cycles - _zk_rows(cycles)
    rng = np.random.default_rng(seed)

    x = np.zeros(cycles, np.uint64)
    x[0], x[1] = f0 % F.P, f1 % F.P
    for i in range(2, active):
        x[i] = (x[i - 1] + x[i - 2]) % F.P
    x[active:] = rng.integers(0, F.P, size=cycles - active)

    code = np.zeros((4, cycles), np.uint32)
    code[0, 0] = 1
    code[1, 1] = 1
    code[2, 2:active] = 1
    code[3, active - 1] = 1

    out = np.array([f0 % F.P, f1 % F.P, x[active - 1]], np.uint32)
    return (
        F.encode_np(code),
        F.encode_np(x.astype(np.uint32))[None, :],
        F.encode_np(out),
        active,
    )


def accum_witgen(data_mont: np.ndarray, mix_mont: np.ndarray, active: int,
                 seed: int | None = None):
    cycles = data_mont.shape[1]
    rng = np.random.default_rng(None if seed is None else seed + 1)
    a = F.mul_np(data_mont[0], np.full(cycles, mix_mont[0], np.uint32))
    a[active:] = F.encode_np(rng.integers(0, F.P, size=cycles - active,
                                          dtype=np.uint32))
    return a[None, :]


def _inv_zeros_pattern(po2: int) -> np.ndarray:
    """1 / ((3x)^cycles - 1) over the shifted 4x domain: period 4."""
    cycles = 1 << po2
    w = F.s_encode(F.ROU_FWD[po2 + 2])
    k = F.s_pow(F.s_encode(3), cycles)
    wq = F.s_pow(w, cycles)  # 4th root of unity
    ys = []
    cw = F.MONT_ONE
    for _ in range(4):
        ys.append(F.s_inv(F.s_sub(F.s_mul(k, cw), F.MONT_ONE)))
        cw = F.s_mul(cw, wq)
    return np.array(ys, np.uint32)


class FibCircuitHal:
    """eval_check on the device of the evaluated groups."""

    def eval_check(self, groups, globals_list, poly_mix, po2):
        mix_g, out_g = (np.asarray(g, np.uint32) for g in globals_list)
        accum, code, data = groups
        dev = data.device
        domain = (1 << po2) * INV_RATE

        pm_pows = F.ext_powers_np(np.asarray(poly_mix, np.uint32),
                                  NUM_CONSTRAINTS)
        a = accum[0]
        s0, s1, rec, fini = code
        x0 = data[0]
        x1 = torch.roll(x0, INV_RATE * 1)
        x2 = torch.roll(x0, INV_RATE * 2)
        mix0, f0, f1, fl = (int(v) for v in (mix_g[0], *out_g))
        cons = [
            F.mul(s0, F.sub(x0, f0)),
            F.mul(s1, F.sub(x0, f1)),
            F.mul(rec, F.sub(x0, F.add(x1, x2))),
            F.mul(fini, F.sub(x0, fl)),
            F.mul(F.add(F.add(s0, s1), F.add(rec, fini)),
                  F.sub(a, F.mul(x0, mix0))),
        ]
        pm = hal.as_words(pm_pows, dev)
        terms = torch.stack([F.mul(pm[i][None, :], c[:, None])
                             for i, c in enumerate(cons)])
        tot = F.sum_mod(terms, 0)
        invz = hal.as_words(np.tile(_inv_zeros_pattern(po2), domain // 4),
                            dev)
        return F.mul(tot, invz[:, None]).T.contiguous()  # (4, domain)


def poly_ext(poly_mix, eval_u, out, mix):
    """Host constraint evaluation at the DEEP point (verifier side)."""
    u = [np.asarray(e, np.uint32) for e in eval_u]
    a, s0, s1, rec, fini, x0, x1, x2 = u
    out = np.asarray(out, np.uint32)
    mix = np.asarray(mix, np.uint32)

    def scale(sel, val):
        return F.ext_mul_np(sel, val)

    def c_sub(v, scalar_mont):
        e = np.zeros(4, np.uint32)
        e[0] = scalar_mont
        return F.sub_np(v, e)

    cons = [
        scale(s0, c_sub(x0, int(out[0]))),
        scale(s1, c_sub(x0, int(out[1]))),
        scale(rec, F.sub_np(x0, F.add_np(x1, x2))),
        scale(fini, c_sub(x0, int(out[2]))),
        scale(F.add_np(F.add_np(s0, s1), F.add_np(rec, fini)),
              F.sub_np(a, F.mul_np(x0, np.uint32(mix[0])))),
    ]
    tot = poly.ext_zero()
    cur = poly.ext_one()
    for c in cons:
        tot = F.add_np(tot, F.ext_mul_np(cur, c))
        cur = F.ext_mul_np(cur, np.asarray(poly_mix, np.uint32))
    return tot


class FibCircuit:
    taps = TAPS
    CIRCUIT_INFO = CIRCUIT_INFO
    OUTPUT_SIZE = OUTPUT_SIZE
    MIX_SIZE = MIX_SIZE

    @staticmethod
    def poly_ext(poly_mix, eval_u, out, mix):
        return poly_ext(poly_mix, eval_u, out, mix)


def _info_digest(suite, info: bytes):
    words = np.frombuffer(info.ljust(16, b"\0")[:16], np.uint8)
    return suite.hash_elem_slice(F.encode_np(words.astype(np.uint32)))


def prove(po2: int, f0: int = 1, f1: int = 1, seed: int = 0, device="cuda",
          suite=None):
    """Produce a fib seal on `device` (the card unless the caller names
    another) under `suite` (default Poseidon2)."""
    device = card(device)
    suite = suite or POSEIDON2
    code, data, out, active = witgen(po2, f0, f1, seed)

    prover = Prover(suite, TAPS, device)
    iop = prover.iop
    iop.write_u32s([SEAL_VERSION])
    iop.commit(_info_digest(suite, V.PROOF_SYSTEM_INFO))
    iop.commit(_info_digest(suite, CIRCUIT_INFO))

    header = np.concatenate([out, np.array([po2], np.uint32)])  # po2 raw
    iop.commit(suite.hash_elem_slice(header))
    iop.write_field_elems(header)
    prover.set_po2(po2)

    prover.commit_group(REGISTER_GROUP_CODE, code)
    prover.commit_group(REGISTER_GROUP_DATA, data)

    mix = np.array([iop.random_elem() for _ in range(MIX_SIZE)], np.uint32)
    accum = accum_witgen(data, mix, active, seed)
    prover.commit_group(REGISTER_GROUP_ACCUM, accum)

    return prover.finalize([mix, out], FibCircuitHal())


def code_root(po2: int, device="cuda", suite=POSEIDON2) -> np.ndarray:
    """Deterministic code-group Merkle root for check_code."""
    device = card(device)
    code, _, _, _ = witgen(po2)
    coeffs = hal.make_coeffs(hal.as_words(code, device))
    return PolyGroup.from_coeffs(coeffs, suite).merkle.root


def verify(seal: np.ndarray, device="cuda", suite=None):
    """Verify a fib seal under `suite` (default Poseidon2); the code root
    is recomputed on `device`."""
    device = card(device)
    suite = suite or POSEIDON2
    seal = np.asarray(seal, np.uint32)
    if len(seal) == 0 or seal[0] != SEAL_VERSION:
        raise V.VerificationError("bad seal version")

    def check_code(po2, root):
        if not np.array_equal(np.asarray(root),
                              code_root(po2, device, suite)):
            raise V.VerificationError("code root mismatch")

    return V.verify(FibCircuit(), suite, seal[1:], check_code)
