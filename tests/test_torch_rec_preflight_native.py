"""The recursion preflight's host C++ interpreter against the JAX package.

  * `RecursionPreflight.run` (one native call, csrc/rec_preflight.cpp) gives
    the JAX package's Python preflight's WOM, IOP rows, cycles, output,
    checked-byte reads and collected EQ failures, bit for bit, on: the po2 11
    program of tests/test_torch_recursion.py; lift_rv32im_14 on a real
    segment seal; a program built here with the assembler that reaches the
    ops the vendored lifts never do (checked bytes, select, extract, both
    inverse forms, the sha cycle, both bit ops, IOP reads of every k), in
    strict mode and with the EQ failures collected;
  * each fault raises the same exception class from the native run and
    from the port's hand-written Python twin (`step`);
  * the host library builds with the C++ compiler alone (no nvcc), and two
    processes building it at once leave one loadable library;
  * a run counts its rows on the `rec_preflight` span and in the
    `risc0_rec_preflight_rows` counter.

The JAX run of lift_rv32im_14 takes tens of seconds on a CPU, so its case
is the only one that runs it.
"""

import contextlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from risc0_tpu_torch import perf, telemetry
from risc0_tpu_torch.circuit.recursion import native
from risc0_tpu_torch.circuit.recursion.asm import Asm
from risc0_tpu_torch.circuit.recursion.preflight import (M_CONST,
                                                         MICRO_INSTS,
                                                         SEL_MICRO,
                                                         WRITE_ADDR,
                                                         RecursionPreflight)
from risc0_tpu_torch.circuit.recursion.predicates import (load_own_program,
                                                          own_control_ids)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT_SEAL = os.path.join(REPO, "tests", "data", "rv32im_seal_po2_14.npy")
RESULTS = ("wom", "iops", "cycles", "output", "byte_reads", "eq_failures")


def _asm_case():
    from test_torch_recursion import _asm_program

    jprog, inp = _asm_program()
    return jprog.code, inp


def _lift_case(seal):
    _ids, root = own_control_ids()
    tape = [int(w) for w in np.asarray(root, np.uint32)] + \
        [int(w) for w in seal]
    return load_own_program("lift_rv32im_14").code, tape


def _wide_case(failing_eq=False):
    """Every op kind the VM has, over a tape of random u32 words."""
    a = Asm()
    a.read_iop_header(3, k=1)
    v = [a.read_iop_body(do_mont=True) for _ in range(3)]
    a.read_iop_header(2, k=4)
    e = [a.read_iop_body(do_mont=False) for _ in range(2)]
    a.read_iop_header(2, k=4, flip=True)
    f = [a.read_iop_body(do_mont=True) for _ in range(2)]
    a.read_iop_header(4, k=2)
    s = [a.read_iop_body(do_mont=False) for _ in range(4)]
    x = a.mul(e[0], f[1])
    y = a.sub(x, e[1])
    z = a.add(y, v[0])
    a.eq(x, x)
    if failing_eq:
        a.eq(v[0], v[1])
    inv = a.inv(z)
    zero, nonzero = a.iszero(a.const(0)), a.iszero(v[1])
    ex = [a.extract(z, j) for j in range(4)]
    sel = a.select(a.const(1), v[0], 1)
    mix = a.mix_rng(v[0], v[1])
    a.mix_rng(v[2], ex[0], cont_mult=5)
    bits = [a.bit_and_elem(s[0], s[1]), a.bit_op_shorts(s[2], s[3], True),
            a.bit_op_shorts(s[2], s[3], False)]
    words = s + [a.const(i * 977 & 0xFFFF, i * 31 & 0xFFFF)
                 for i in range(28)]
    digest = a.sha256(words)
    a.p2_load([v[0], v[1], v[2], z, inv, mix, sel, ex[1]], group=0,
              do_mont=1, keep_state=0, keep_upper=0)
    a.p2_load(digest, group=1, do_mont=0, keep_state=1, keep_upper=1)
    a.p2_load(bits + ex + [zero], group=2, do_mont=0, keep_state=1,
              keep_upper=1, prep_full=True)
    a.p2_permute()
    h0, h2 = a.p2_store(group=0, do_mont=1), a.p2_store(group=2, do_mont=0)
    a.checked_bytes(z, keep_coeffs=0, keep_upper=0)
    cb = a.checked_bytes(z, keep_coeffs=1, keep_upper=1, prep_full=True)
    a.p2_permute()
    h1 = a.p2_store(group=1, do_mont=1)
    for out in (z, nonzero, digest[0], h0, h2 + 7, cb, h1 + 3):
        a.output(out)
    tape = np.random.default_rng(11).integers(0, 1 << 32, 31,
                                              dtype=np.uint64)
    return a.program(11).code, [int(w) for w in tape]


@pytest.fixture(scope="module")
def seal():
    return np.load(SEGMENT_SEAL)


def _case(name, seal):
    if name == "asm":
        return _asm_case()
    if name == "lift_rv32im_14":
        return _lift_case(seal)
    return _wide_case(failing_eq=name == "wide_eq_collected")


@pytest.mark.parametrize("name, strict", [
    ("asm", True), ("lift_rv32im_14", True), ("wide", True),
    ("wide_eq_collected", False)])
def test_native_preflight_matches_jax(name, strict, seal):
    from risc0_tpu.circuit.recursion.preflight import \
        RecursionPreflight as JPreflight

    code, tape = _case(name, seal)
    want = JPreflight(tape, eq_strict=strict)
    want.run(code)
    got = RecursionPreflight(tape, eq_strict=strict)
    got.run(code)
    for key in RESULTS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.input_used == len(tape) - len(want.input)
    assert len(got.cycles) == len(code)
    if name.startswith("wide"):
        assert got.byte_reads and len(got.output) == 7
        assert bool(got.eq_failures) == (not strict)


def _overwrite_case():
    row = np.zeros((2, 23), np.uint32)
    row[:, SEL_MICRO] = 1
    row[:, WRITE_ADDR] = 1
    for i, inst in enumerate(MICRO_INSTS):
        row[:, inst[0]] = M_CONST
        row[:, inst[1]] = 5 + i
    row[1, MICRO_INSTS[0][1]] = 6   # address 1 again, another value
    return row, []


def _eq_case():
    a = Asm()
    a.eq(a.const(1), a.const(2))
    return a.program(11).code, []


def _short_tape_case():
    a = Asm()
    a.read_iop_header(4, k=1)
    for _ in range(4):
        a.read_iop_body()
    return a.program(11).code, [1, 2]


def _illegal_op_case():
    code, _ = _eq_case()
    code = code.copy()
    code[1, :8] = 0        # no selector set
    return code, []


def _unknown_opcode_case():
    code, _ = _eq_case()
    code = code.copy()
    code[1, MICRO_INSTS[2][0]] = 11
    return code, []


def _unwritten_read_case():
    a = Asm()
    a.add(a.const(1), 1000)
    return a.program(11).code, []


def _flipped_seal_case(seal):
    bad = seal.copy()
    bad[3] ^= 1
    return _lift_case(bad)


@pytest.mark.parametrize("fault, cls", [
    ("wom_overwrite", ValueError), ("failed_strict_eq", ValueError),
    ("short_tape", IndexError), ("illegal_op", ValueError),
    ("unknown_micro_opcode", ValueError), ("unwritten_wom_read", IndexError),
    ("flipped_seal_word", ValueError)])
def test_native_fault_is_the_twins(fault, cls, seal):
    code, tape = {
        "wom_overwrite": _overwrite_case,
        "failed_strict_eq": _eq_case,
        "short_tape": _short_tape_case,
        "illegal_op": _illegal_op_case,
        "unknown_micro_opcode": _unknown_opcode_case,
        "unwritten_wom_read": _unwritten_read_case,
        "flipped_seal_word": lambda: _flipped_seal_case(seal),
    }[fault]()
    twin = RecursionPreflight(tape)
    with pytest.raises(cls) as twin_err:
        for cycle, row in enumerate(np.asarray(code).tolist()):
            twin.step(cycle, row)
    with pytest.raises(cls) as native_err:
        RecursionPreflight(tape).run(code)
    assert type(native_err.value) is type(twin_err.value)
    assert f"at cycle {cycle}" in str(native_err.value)


_BUILD = ("import sys; from pathlib import Path; "
          "from risc0_tpu_torch.circuit.recursion import native; "
          "print(native.build(Path(sys.argv[1])))")


def test_host_library_builds_without_nvcc_and_races_to_one(tmp_path):
    cxx = shutil.which("c++") or shutil.which("g++")
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    env = dict(os.environ, PATH=path, PYTHONPATH=REPO,
               CUDA_VISIBLE_DEVICES="")
    assert shutil.which("nvcc", path=path) is None
    assert cxx and shutil.which(os.path.basename(cxx), path=path)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = {out.strip().splitlines()[-1] for out, _err in outs}
    assert built == {str(native.library_path(tmp_path))}
    assert sorted(os.listdir(tmp_path)) == [native.library_path().name]
    code, tape = _wide_case()
    got = native.run(code, tape, library=native.load(built.pop()))
    want = RecursionPreflight(tape)
    for cycle, row in enumerate(code.tolist()):
        want.step(cycle, row)
    assert [tuple(r) for r in got["wom"].tolist()] == want.wom


@pytest.mark.parametrize("wrapped", [False, True])
def test_run_counts_rows_on_span_and_counter(wrapped, monkeypatch):
    if wrapped:     # a caller's wrapper that yields nothing, as a profiler's
        inner = perf.scope

        @contextlib.contextmanager
        def scope(name, sync=None):
            with inner(name, sync=sync):
                yield

        monkeypatch.setattr(perf, "scope", scope)
    code, tape = _wide_case()
    counter = "risc0_rec_preflight_rows"
    before = telemetry.metrics().snapshot()["counters"].get(counter, 0.0)
    pf = RecursionPreflight(tape)
    pf.run(code)
    after = telemetry.metrics().snapshot()["counters"][counter]
    assert after - before == len(code)
    span = telemetry.tracer().finished("rec_preflight")[-1]
    assert span.attributes["rows"] == len(code)
    with pytest.raises(ValueError):
        pf.run(code)        # a preflight runs once


def test_tape_words_are_read_mod_2_32_in_any_form():
    code, tape = _wide_case()
    forms = [tape, [w + (3 << 32) for w in tape],
             np.asarray(tape, np.uint64), np.asarray(tape, np.uint32)]
    runs = []
    for words in forms:
        pf = RecursionPreflight(words)
        pf.run(code)
        runs.append(pf.arrays)
    for got in runs[1:]:
        for key in ("wom", "iops", "output", "byte_reads"):
            assert np.array_equal(got[key], runs[0][key]), key
