"""Make the keccak seal fixture with the JAX package on the CPU: the po2 14
keccak seal of the two states of ``default_rng(14)``, the inputs of the
golden ``tests/data/keccak_lift14_seal`` (scripts/gen_recursion_seals.py
--keccak).  The JAX keccak prove draws no randomness, so the seal is a
function of its inputs, and the port's seal is held to it word for word.

    python scripts/gen_keccak_seal.py [out.npy]

Default output: tests/data/keccak_seal_po2_14.npy (about 49 min on the
CPU).
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "keccak_seal_po2_14.npy")


def inputs():
    """The two keccak states of the golden keccak lift fixture."""
    rng = np.random.default_rng(14)
    return [[int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
            for _ in range(2)]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from risc0_tpu.circuit.keccak.prove import prove_keccak

    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    t0 = time.time()
    seal = np.asarray(prove_keccak(inputs(), 14), np.uint32)
    np.save(out, seal)
    print(f"{out}: {len(seal)} words in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
