"""Recursion VM preflight: execute a recursion program's code rows
(the port's host copy of ``risc0_tpu/circuit/recursion/preflight.py``).

Literal port of the reference preflight (risc0/circuit/recursion/src/prove/
preflight.rs): the recursion circuit is a write-once-memory VM with micro
ops (const/add/sub/mul/inv/eq/iop/mix_rng/select/extract), macro ops
(bit ops, sha-256), poseidon2 load/full/partial/store rows, and checked
bytes.  The preflight interprets the program to collect the WOM contents,
IOP read values, and per-cycle parallel-safety used by witness generation.

All field values are STANDARD form u32 (Fp) / 4-tuples (FpExt).

`RecursionPreflight.run` interprets the rows in host C++ (`native.py`,
`csrc/rec_preflight.cpp`), one call a program; the per-row methods below
are its hand-written Python twin, which the tests hold it against.
"""

from __future__ import annotations

from collections import deque
from functools import cached_property

import numpy as np

from ... import field as F
from ... import perf, telemetry
from ...hash import poseidon2 as p2
from ..keccak.preflight import SHA_INIT, compute_sha_infos
from . import native

P = F.P
R_MOD_P = F.R % F.P            # BABY_BEAR_TO_MONTGOMERY (0xFFFFFFE)
R_INV = pow(R_MOD_P, P - 2, P)  # BABY_BEAR_FROM_MONTGOMERY (0x38400000)

CHECKED_COEFFS_PER_POLY = 16
OPERANDS = 3
OPS_PER_CYCLE = 3

# micro opcodes (reference preflight.rs:44-56)
(M_CONST, M_ADD, M_SUB, M_MUL, M_INV, M_EQ, M_READ_IOP_HEADER,
 M_READ_IOP_BODY, M_MIX_RNG, M_SELECT, M_EXTRACT) = range(11)

# CODE_LAYOUT offsets (reference layout.rs.inc:223-335)
WRITE_ADDR = 0
SEL_MICRO, SEL_MACRO, SEL_P2_LOAD, SEL_P2_FULL, SEL_P2_PARTIAL, \
    SEL_P2_STORE, SEL_CHECKED = 1, 2, 3, 4, 5, 6, 7
MICRO_INSTS = [(8, 9, 10, 11), (12, 13, 14, 15), (16, 17, 18, 19)]
MACRO_OPCODE = {  # one-hot select regs
    "nop": 8, "wom_init": 9, "wom_fini": 10, "bit_and_elem": 11,
    "bit_op_shorts": 12, "sha_init": 13, "sha_fini": 14, "sha_load": 15,
    "sha_mix": 16, "set_global": 17,
}
MACRO_OPERAND = (18, 19, 20)
P2_DO_MONT, P2_KEEP_STATE, P2_KEEP_UPPER = 8, 9, 10
P2_G1, P2_G2 = 13, 14
P2_INPUTS = list(range(15, 23))
CB_EVAL_POINT, CB_KEEP_COEFFS, CB_KEEP_UPPER, CB_PREP_FULL = 8, 9, 10, 11


def _eadd(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def _esub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def _emul(a, b):
    nb = P - 11
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return ((a0 * b0 + nb * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
            (a0 * b1 + a1 * b0 + nb * (a2 * b3 + a3 * b2)) % P,
            (a0 * b2 + a1 * b1 + a2 * b0 + nb * (a3 * b3)) % P,
            (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P)


def _einv(a):
    out = F.ext_inv_np(F.encode_np(np.array(a, np.uint32)))
    return tuple(int(x) for x in F.decode_np(out))


def _poseidon2_mix(cells):
    # permute_np operates on Montgomery-form cells; preflight state is
    # standard form, so encode/decode around the permutation
    enc = F.encode_np(np.array(cells, np.uint32))
    out = F.decode_np(p2.permute_np(enc[None, :])[0])
    return [int(x) for x in out]


def _byteswap32(x):
    return ((x & 0xFF) << 24 | (x & 0xFF00) << 8 |
            (x >> 8) & 0xFF00 | (x >> 24) & 0xFF)


EZERO = (0, 0, 0, 0)


def _tape(words):
    """Input words as u32 (each taken mod 2^32, as the VM reads them)."""
    arr = np.asarray(words)
    if arr.dtype.kind not in "iu":
        arr = np.array([int(x) & 0xFFFFFFFF for x in words], np.uint64)
    return arr.astype(np.uint32).ravel()


# what `run` leaves as arrays; the properties below read them as lists
_RUN_RESULTS = ("wom", "iops", "cycles", "output", "eq_failures",
                "byte_reads", "input")


class RecursionPreflight:
    def __init__(self, input_words, eq_strict=True):
        self.eq_strict = eq_strict
        self.tape = _tape(input_words)
        self.input_used = 0
        self.arrays = None       # the native run's results (`run`)
        # the Python twin's state; after `run` the result lists are built
        # from `arrays` on first access (the cached properties below)
        self.eq_failures = []
        self.wom = []            # list of 4-tuples
        self.iops = []           # list of 4-tuples
        self.cycles = []         # (iop_idx, is_par_safe)
        self.output = []
        self.poseidon2_state = [0] * 24
        self.sha_state = [0] * 8
        self.sha_load = [0] * 16
        self.sha_init_pos = 0
        self.sha_load_pos = 0
        self.sha_fini_pos = 0
        self.byte_reads = {}
        self.eval_pts = {}
        self.cur_iop_body = deque()
        self.iop_idx = 0

    # -- wom ----------------------------------------------------------------
    def wom_read(self, addr):
        return self.wom[int(addr)]

    def wom_write(self, addr, val):
        addr = int(addr)
        if len(self.wom) <= addr:
            self.wom.extend([EZERO] * (addr + 1 - len(self.wom)))
        cur = self.wom[addr]
        if cur != EZERO and cur != tuple(val):
            raise ValueError(f"WOM {addr} overwritten: {val} over {cur}")
        self.wom[addr] = tuple(val)

    # -- results of a native run, as the Python twin keeps them --------------
    @cached_property
    def input(self):
        return deque(self.tape[self.input_used:].tolist())

    @cached_property
    def wom(self):
        return [tuple(r) for r in self.arrays["wom"].tolist()]

    @cached_property
    def iops(self):
        return [tuple(r) for r in self.arrays["iops"].tolist()]

    @cached_property
    def cycles(self):
        return list(zip(self.arrays["iop_idx"].tolist(),
                        self.arrays["par_safe"].tolist()))

    @cached_property
    def output(self):
        return self.arrays["output"].tolist()

    @cached_property
    def eq_failures(self):
        return [(r[0], tuple(r[1:5]), tuple(r[5:9]))
                for r in self.arrays["eq_failures"].tolist()]

    @cached_property
    def byte_reads(self):
        return {r[0]: r[1:] for r in self.arrays["byte_reads"].tolist()}

    # -- program ------------------------------------------------------------
    def run(self, code_rows):
        """Interpret every code row in one native call, timed as
        `rec_preflight`; a failing in-VM assertion raises the exception
        class the Python twin raises.  Leaves the results in `arrays`."""
        if self.arrays is not None or self.cycles:
            raise ValueError("a preflight runs its program once")
        with perf.scope("rec_preflight"):
            self.arrays = native.run(code_rows, self.tape, self.eq_strict)
            rows = len(self.arrays["iop_idx"])
            telemetry.tracer().annotate(rows=rows)
        telemetry.metrics().inc("risc0_rec_preflight_rows", rows)
        self.input_used = self.arrays["input_used"]
        for name in _RUN_RESULTS:
            self.__dict__.pop(name, None)

    def step(self, cycle, code):
        if code[SEL_MACRO] == 1:
            par = self.macro_op(cycle, code)
        elif code[SEL_MICRO] == 1:
            par = self.micro_ops(cycle, code)
        elif code[SEL_CHECKED] == 1:
            par = self.checked_bytes(cycle, code)
        elif code[SEL_P2_LOAD] == 1:
            par = self.poseidon2_load(code)
        elif code[SEL_P2_FULL] == 1:
            par = False
        elif code[SEL_P2_PARTIAL] == 1:
            self.poseidon2_state = _poseidon2_mix(self.poseidon2_state)
            par = False
        elif code[SEL_P2_STORE] == 1:
            par = self.poseidon2_store(code)
        else:
            raise ValueError(f"illegal recursion op at cycle {cycle}")
        self.cycles.append((self.iop_idx, 1 if par else 0))
        self.iop_idx = len(self.iops)

    # -- iop ----------------------------------------------------------------
    def _read_iop_header(self, count, k_flip):
        # k_flip packs k*2 + flip (reference preflight.rs:115-119)
        count, k_flip = int(count), int(k_flip)
        k, flip = k_flip // 2, bool(k_flip & 1)
        assert not self.cur_iop_body
        if k == 2:
            for _ in range(count):
                w = self.input.popleft()
                self.cur_iop_body.append([w & 0xFFFF, w >> 16])
        else:
            arr = [self.input.popleft() for _ in range(k * count)]
            for i in range(count):
                poly = []
                for j in range(k):
                    raw = arr[i * k + j] if flip else arr[j * count + i]
                    poly.append(raw * R_INV % P)  # new_raw = decode
                self.cur_iop_body.append(poly)

    def read_iop_body(self, do_mont):
        front = list(self.cur_iop_body.popleft())
        front += [0] * (4 - len(front))
        if do_mont != 0:
            front = [x * R_MOD_P % P for x in front]
        return tuple(front[:4])

    # -- micro ops ----------------------------------------------------------
    def micro_ops(self, cycle, code):
        write_addr = code[WRITE_ADDR]
        par = True
        for i in range(OPS_PER_CYCLE):
            par &= self.micro_op(cycle, code, write_addr + i,
                                 MICRO_INSTS[i])
        return par

    def micro_op(self, cycle, code, write_addr, inst):
        opcode = code[inst[0]]
        args = [code[inst[1]], code[inst[2]], code[inst[3]]]
        if opcode == M_CONST:
            self.wom_write(write_addr, (args[0], args[1], 0, 0))
            return True
        if opcode == M_ADD:
            a = self.wom_read(args[0])
            b = self.wom_read(args[1])
            self.wom_write(write_addr, _eadd(a, b))
            if args[2] != 0:
                self.output.append(a[0])
            return True
        if opcode == M_SUB:
            self.wom_write(write_addr, _esub(self.wom_read(args[0]),
                                             self.wom_read(args[1])))
            return True
        if opcode == M_MUL:
            self.wom_write(write_addr, _emul(self.wom_read(args[0]),
                                             self.wom_read(args[1])))
            return True
        if opcode == M_INV:
            a = self.wom_read(args[0])
            if args[1] == 0:
                r = 1 if a[0] == 0 else 0
                self.wom_write(write_addr, (r, 0, 0, 0))
            else:
                self.wom_write(write_addr, _einv(a))
            return True
        if opcode == M_EQ:
            a = self.wom_read(args[0])
            b = self.wom_read(args[1])
            if a != b:
                if self.eq_strict:
                    raise ValueError(
                        f"recursion EQ failed at cycle {cycle}: {a} != {b}")
                self.eq_failures.append((cycle, a, b))
            return True
        if opcode == M_READ_IOP_HEADER:
            self._read_iop_header(args[0], args[1])
            return True
        if opcode == M_READ_IOP_BODY:
            body = self.read_iop_body(args[2])
            self.wom_write(write_addr, body)
            self.iops.append(body)
            return True
        if opcode == M_MIX_RNG:
            val = args[2]
            par = True
            if args[2] != 0:
                prev = self.wom_read(write_addr - 1)[0]
                val = val * prev % P
                par = False
            a = self.wom_read(args[0])
            b = self.wom_read(args[1])
            for elem in (a[1], a[0], b[1], b[0]):
                val = (val * (1 << 16) + elem) % P
            self.wom_write(write_addr, (val, 0, 0, 0))
            return par
        if opcode == M_SELECT:
            a = self.wom_read(args[0])
            val = self.wom_read((args[1] + args[2] * a[0]) % P)
            self.wom_write(write_addr, val)
            return True
        if opcode == M_EXTRACT:
            a = self.wom_read(args[0])
            b1, b2 = args[1], args[2]
            val = (b1 * b2 * a[3] + b1 * (1 - b2) * a[2] +
                   (1 - b1) * b2 * a[1] + (1 - b1) * (1 - b2) * a[0]) % P
            self.wom_write(write_addr, (val, 0, 0, 0))
            return True
        raise ValueError(f"unknown micro opcode {opcode}")

    # -- macro ops ----------------------------------------------------------
    def macro_op(self, cycle, code):
        op = {name: code[off] for name, off in MACRO_OPCODE.items()}
        args = [code[o] for o in MACRO_OPERAND]
        write_addr = code[WRITE_ADDR]
        if op["bit_and_elem"] == 1:
            a = self.wom_read(args[0])
            b = self.wom_read(args[1])
            self.wom_write(write_addr, (a[0] & b[0], 0, 0, 0))
            return True
        if op["bit_op_shorts"] == 1:
            a = self.wom_read(args[0])
            b = self.wom_read(args[1])
            if args[2] != 0:
                r = ((a[0] & b[0]) + ((a[1] & b[1]) << 16), 0, 0, 0)
            else:
                r = (a[0] ^ b[0], a[1] ^ b[1], 0, 0)
            self.wom_write(write_addr, r)
            return True
        if op["sha_init"] == 1:
            # SHA256_INIT words are stored byteswapped; .to_be() restores the
            # standard IV (reference sha/mod.rs:59, preflight.rs:407)
            if self.sha_init_pos == 0:
                self.sha_state = list(SHA_INIT)
            self.sha_init_pos = (self.sha_init_pos + 1) % 4
            return False
        if op["sha_load"] == 1:
            io0 = self.wom_read(args[0])
            if args[2] == 0:
                val = io0[0] * R_MOD_P % P  # as_u32_montgomery
            else:
                val = (io0[0] + (io0[1] << 16)) & 0xFFFFFFFF
            self.sha_load[self.sha_load_pos] = val
            self.sha_load_pos = (self.sha_load_pos + 1) % 16
            return False
        if op["sha_mix"] == 1:
            return False
        if op["sha_fini"] == 1:
            if self.sha_fini_pos == 0:
                compute_sha_infos(self.sha_state, list(self.sha_load))
                out_addr = args[0] - 3
                for i in range(8):
                    out = _byteswap32(self.sha_state[i])
                    self.wom_write(out_addr + i,
                                   (out & 0xFFFF, out >> 16, 0, 0))
            self.sha_fini_pos = (self.sha_fini_pos + 1) % 4
            return False
        # nop / wom_init / wom_fini / set_global
        return True

    # -- poseidon2 ----------------------------------------------------------
    def poseidon2_load(self, code):
        do_mont = code[P2_DO_MONT]
        keep_state = code[P2_KEEP_STATE]
        keep_upper = code[P2_KEEP_UPPER]
        group = code[P2_G1] + code[P2_G2] * 2
        if keep_state != 1:
            if keep_upper != 1:
                self.poseidon2_state = [0] * 24
            else:
                for i in range(16):
                    self.poseidon2_state[i] = 0
        for i in range(8):
            addr = code[P2_INPUTS[i]]
            load = self.wom_read(addr)[0]
            if do_mont != 0:
                load = load * R_INV % P
            self.poseidon2_state[group * 8 + i] = \
                (self.poseidon2_state[group * 8 + i] + load) % P
        return False

    def poseidon2_store(self, code):
        do_mont = code[P2_DO_MONT]
        group = code[P2_G1] + code[P2_G2] * 2
        write_addr = code[WRITE_ADDR]
        for i in range(8):
            store = self.poseidon2_state[group * 8 + i]
            if do_mont != 0:
                store = store * R_MOD_P % P
            self.wom_write(write_addr + i, (store, 0, 0, 0))
        return False

    # -- checked bytes ------------------------------------------------------
    def checked_bytes(self, cycle, code):
        keep_coeffs = code[CB_KEEP_COEFFS]
        keep_upper = code[CB_KEEP_UPPER]
        if keep_coeffs == 1:
            for i in range(16):
                self.poseidon2_state[i] = self.poseidon2_state[i] * 256 % P
        else:
            for i in range(16):
                self.poseidon2_state[i] = 0
        if keep_upper != 1:
            for i in range(16, 24):
                self.poseidon2_state[i] = 0

        eval_pt_addr = code[CB_EVAL_POINT]
        write_addr = code[WRITE_ADDR]
        if eval_pt_addr in self.eval_pts:
            pows = self.eval_pts[eval_pt_addr]
        else:
            pt = self.wom_read(eval_pt_addr)
            pows = [(1, 0, 0, 0)]
            for _ in range(CHECKED_COEFFS_PER_POLY - 1):
                pows.append(_emul(pows[-1], pt))
            self.eval_pts[eval_pt_addr] = pows
        evaluated = EZERO
        cycle_input = []
        for i in range(4):
            word = self.input.popleft()
            for j in range(4):
                b = (word >> (8 * j)) & 0xFF
                idx = i * 4 + j
                self.poseidon2_state[idx] = \
                    (self.poseidon2_state[idx] + b) % P
                evaluated = _eadd(evaluated,
                                  tuple(x * b % P for x in pows[idx]))
            cycle_input.append(word)
        assert cycle not in self.byte_reads
        self.byte_reads[cycle] = cycle_input
        self.wom_write(write_addr, evaluated)
        return False

