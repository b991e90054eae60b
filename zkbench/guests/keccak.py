"""The keccak composition guest (risc0_tpu_torch.keccak_guest.build_stdin):
it reads batch sizes, a start state, the batch claims, the root claim and
the output digest, permutes the state in place with SYS_KECCAK, flushes
each batch to the keccak coprocessor under its claim, assumes the root
claim with SYS_VERIFY_INTEGRITY2 and commits the final state.  This module
makes its inputs: a start state drawn from the seed, and every claim and
digest from the plain reference (zkbench/reference/keccak.py), as risc0's
guest-side batcher would commit them."""

import os
import struct

import numpy as np

from zkbench.reference import claims, keccak


def elf(root: str, config) -> bytes:
    """The guest as built by build_stdin for the configured number of
    batches, kept as a file so that the cell's work is fixed."""
    with open(os.path.join(root, config["elf"]), "rb") as f:
        return f.read()


def inputs(config, rng: np.random.Generator, sizes=None) -> dict:
    """{"stdin": the guest's input, "sizes", "start", "batches" (each
    batch's states), "claims", "root_claim", "journal", "output"}; `sizes`
    defaults to the configuration's batches."""
    sizes = list(config["keccak_batches"] if sizes is None else sizes)
    start = [int(v) for v in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
    batches, final = keccak.chain(start, sizes)
    batch_claims = [keccak.batch_claim(b) for b in batches]
    _ids, root = claims.allowed_set()
    control_root = struct.pack("<8I", *root)
    root_claim = keccak.root_claim(batch_claims, control_root)
    journal = keccak.state_bytes(final)
    # the guest assumes the root under the zero control root
    output = keccak.output_with(journal,
                                [keccak.assumption(root_claim, claims.ZERO)])
    stdin = (struct.pack(f"<{len(sizes)}I", *sizes) + keccak.state_bytes(start)
             + b"".join(batch_claims) + root_claim + output)
    return {"stdin": stdin, "sizes": sizes, "start": start,
            "batches": batches, "claims": batch_claims,
            "root_claim": root_claim, "journal": journal, "output": output}
