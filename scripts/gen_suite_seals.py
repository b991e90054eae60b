"""Make the hash-suite seal fixtures with the JAX package on the CPU:

  * the fib po2 6 seal (seed 0) under the SHA-256, Poseidon254 and Blake2b
    suites: tests/data/fib_seal_po2_6_{sha256,poseidon254,blake2b}.npy;
  * the po2 11 recursion program of tests/test_torch_recursion.py (built
    with the JAX assembler, input words from default_rng(6)), proved under
    the Poseidon254 suite with rng default_rng(9):
    tests/data/recursion_seal_asm_po2_11_p254.npy.

Every seal is a function of its inputs and its rng, so the port's seals
are held to these word for word.

    python scripts/gen_suite_seals.py [out_dir]

Default output directory: tests/data (a few minutes on the CPU).
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FIB_SUITES = ("sha256", "poseidon254", "blake2b")


def fib_name(suite: str) -> str:
    return f"fib_seal_po2_6_{suite}.npy"


ASM_P254 = "recursion_seal_asm_po2_11_p254.npy"


def asm_program():
    """The po2 11 program: read 8 words, sum their squares, write four
    globals; and its input words."""
    from risc0_tpu import field as F
    from risc0_tpu.circuit.recursion.asm import Asm

    a = Asm()
    a.read_iop_header(8, k=1)
    vals = [a.read_iop_body(do_mont=True) for _ in range(8)]
    sq = [a.mul(v, v) for v in vals]
    tot = sq[0]
    for s in sq[1:]:
        tot = a.add(tot, s)
    ex = a.extract(tot, 0)
    outs = [a.add(ex, a.const(i)) for i in range(16)]
    for k in range(4):
        a.set_global(outs[4 * k], k)
    prog = a.program(11)
    inp = [int(x) for x in np.random.default_rng(6).integers(0, F.P, 8)]
    return prog, inp


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from risc0_tpu.circuit import fib
    from risc0_tpu.circuit.recursion.prove import prove_program
    from risc0_tpu.hash.suite import POSEIDON254, get_suite

    out_dir = sys.argv[1] if len(sys.argv) > 1 else DATA
    for name in FIB_SUITES:
        t0 = time.time()
        seal = np.asarray(fib.prove(po2=6, suite=get_suite(name), seed=0),
                          np.uint32)
        path = os.path.join(out_dir, fib_name(name))
        np.save(path, seal)
        print(f"{path}: {len(seal)} words in {time.time() - t0:.1f} s")

    t0 = time.time()
    prog, inp = asm_program()
    seal, _out = prove_program(prog, inp, suite=POSEIDON254,
                               rng=np.random.default_rng(9), use_jit=False)
    path = os.path.join(out_dir, ASM_P254)
    np.save(path, np.asarray(seal, np.uint32))
    print(f"{path}: {len(seal)} words in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
