"""A guest that uses the keccak coprocessor and assumes its proof: the
composition path that ``chip_smoke.py`` proves on the card.

Built with the port's assembler (``zkvm/guest.Asm``): the guest permutes
one keccak state in place with ``SYS_KECCAK`` and flushes a batch with
``KECCAK_PROVE`` after each run of permutations in `batches`, then assumes
the union root of the batches' claims with ``SYS_VERIFY_INTEGRITY2`` (the
zero control root: the same verifier context), writes its journal and
halts with the matching output digest.  The claims are computed on the
host when the guest is built, as the guest-side batcher would commit them.

`build_stdin` builds the same guest with its work read from stdin, so one
ELF serves every start state and batch size.
"""

from __future__ import annotations

import numpy as np

from .circuit.keccak import compute_keccak_digest
from .circuit.keccak.preflight import keccak_f
from .zkvm.claims import Assumption, Assumptions, MaybePruned, Output
from .zkvm.guest import Asm
from .zkvm.receipt import keccak_root_claim

_NR = "risc0_zkvm_platform::syscall::nr::"
JOURNAL = b"keccak-composition"


def batch_inputs(batches) -> list[list[list[int]]]:
    """The keccak states each batch permutes: one state, made from seed
    0, permuted in place, `n` times for a batch of n."""
    rng = np.random.default_rng(0)
    state = [int(x) for x in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
    out = []
    for n in batches:
        batch = []
        for _ in range(n):
            batch.append(state)
            state = keccak_f(state)
        out.append(batch)
    return out


def build(batches=(655, 3)):
    """(elf, batch inputs, root claim digest) of the guest."""
    inputs = batch_inputs(batches)
    claims = [compute_keccak_digest(b) for b in inputs]
    root_claim = keccak_root_claim([{"input": b} for b in inputs])
    zero_root = np.zeros(8, np.uint32)
    out = Output.of(JOURNAL, Assumptions(
        [MaybePruned.of(Assumption(root_claim, zero_root))]))

    a = Asm()
    ktok = a.put_data((_NR + "SYS_KECCAK").encode() + b"\0")
    vtok = a.put_data((_NR + "SYS_VERIFY_INTEGRITY2").encode() + b"\0")
    wtok = a.put_data((_NR + "SYS_WRITE").encode() + b"\0")
    state = a.put_data(b"".join(x.to_bytes(8, "little")
                                for x in inputs[0][0]), align=8)
    root_ptr = a.put_data(zero_root.tobytes())
    root_claim_ptr = a.put_data(root_claim.tobytes() + zero_root.tobytes())
    journal = a.put_data(JOURNAL)
    out_digest = a.put_data(np.asarray(out.digest(), np.uint32).tobytes())
    for i, (n, claim) in enumerate(zip(batches, claims)):
        # s0 counts the permutations down: the syscall leaves it alone
        a.li("s0", n)
        a.label(f"permute{i}")
        a.syscall("SYS_KECCAK", ktok, state, 50, args=[0, state, state])
        a.addi("s0", "s0", -1)
        a.bne("s0", "zero", f"permute{i}")
        claim_ptr = a.put_data(claim.tobytes())
        a.syscall("SYS_KECCAK", ktok, 0, 0, args=[1, claim_ptr, root_ptr])
    a.syscall("SYS_VERIFY_INTEGRITY2", vtok, 0, 0, args=[root_claim_ptr, 64])
    a.syscall("SYS_WRITE", wtok, 0, 0, args=[3, journal, len(JOURNAL)])
    a.halt(0, out_digest_token=out_digest)
    return a.link(), inputs, root_claim


# The stdin of the `build_stdin` guest of B batches, in order: B batch
# sizes (u32), the start state (25 u64), B batch claims, the root claim and
# the output digest (32 bytes each), all little-endian.
STDIN_BATCHES = 2


def stdin_size(n_batches: int = STDIN_BATCHES) -> int:
    """Bytes of the `build_stdin` guest's input."""
    return 4 * n_batches + 200 + 32 * n_batches + 32 + 32


def build_stdin(n_batches: int = STDIN_BATCHES) -> bytes:
    """The ELF of the guest with its work read from stdin (above):
    it permutes the start state in place with ``SYS_KECCAK`` as many times
    as each batch's size says and flushes the batch with ``KECCAK_PROVE``
    under its claim, assumes the root claim with ``SYS_VERIFY_INTEGRITY2``
    (the zero control root), writes the final 200-byte state as its journal
    and halts with the output digest.  The host computes the claims and the
    digest, as for `build`."""
    a = Asm()
    ktok = a.put_data((_NR + "SYS_KECCAK").encode() + b"\0")
    vtok = a.put_data((_NR + "SYS_VERIFY_INTEGRITY2").encode() + b"\0")
    wtok = a.put_data((_NR + "SYS_WRITE").encode() + b"\0")
    rtok = a.put_data((_NR + "SYS_READ").encode() + b"\0")
    zero_root = a.put_data(bytes(32))
    # the claim and the zero control root of SYS_VERIFY_INTEGRITY2 sit
    # side by side: the input's root claim is copied in front of the root
    root_claim = a.put_data(bytes(64))
    size = stdin_size(n_batches)
    buf = a.put_data(bytes(size), align=8)

    def at(off):
        return (buf[0], buf[1] + off)

    state = at(4 * n_batches)
    claims = 4 * n_batches + 200
    a.syscall("SYS_READ", rtok, buf, size, args=[0, size])
    for i in range(8):  # root claim -> in front of the zero root
        a.li("t1", at(claims + 32 * n_batches + 4 * i))
        a.lw("t2", "t1", 0)
        a.li("t1", (root_claim[0], root_claim[1] + 4 * i))
        a.sw("t1", "t2", 0)
    for i in range(n_batches):
        # s0 counts the permutations down: the syscall leaves it alone
        a.li("t1", at(4 * i))
        a.lw("s0", "t1", 0)
        a.beq("s0", "zero", f"flush{i}")
        a.label(f"permute{i}")
        a.syscall("SYS_KECCAK", ktok, state, 50, args=[0, state, state])
        a.addi("s0", "s0", -1)
        a.bne("s0", "zero", f"permute{i}")
        a.label(f"flush{i}")
        a.syscall("SYS_KECCAK", ktok, 0, 0,
                  args=[1, at(claims + 32 * i), zero_root])
    a.syscall("SYS_VERIFY_INTEGRITY2", vtok, 0, 0, args=[root_claim, 64])
    a.syscall("SYS_WRITE", wtok, 0, 0, args=[3, state, 200])
    a.halt(0, out_digest_token=at(size - 32))
    return a.link()
