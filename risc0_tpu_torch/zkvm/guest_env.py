# The port's own copy of risc0_tpu/zkvm/guest_env.py, with the running
# assumptions digest of the reference's guest env.
"""In-guest env library for assembler guests — the framework's analog of
the reference guest API `env::{read, commit, exit, verify_integrity}`
(risc0/zkvm/src/guest/env/mod.rs:173-466), emitted as rv32im sequences
over zkvm/guest.py's Asm.

The key piece the bare assembler lacked: a *real* `env::commit` that
computes the receipt-claim output digest IN-GUEST (journal sha -> tagged
risc0.Output digest via the SHA-256 accelerator ecall) so the halting
guest commits the digest of what it journaled — exactly the contract
`Receipt.verify(image_id)` checks.  Journal sizes are compile-time
constants (commit a fixed-size struct), matching serde's word-oriented
guest IO.

As in the reference guest env (guest/env/mod.rs: verify_assumption adds
each Assumption to the running ASSUMPTIONS_DIGEST, which the halt commits
in the Output), every `verify_integrity` and `verify_integrity2` folds
its Assumption{claim, control_root} into a running Assumptions digest
in-guest, and `commit` puts that digest into the Output.  The committed
claim then lists the assumptions that the executor records
(receipt.session_segment_output), so they bind the receipt and resolve
removes them.  The JAX package's GuestEnv commits the empty list whatever
the guest verified, so its guests' seals claim no assumption while their
sessions record some (ROADMAP.md queue 3).
"""

from __future__ import annotations

import hashlib

from .guest import Asm, SYSCALL_CLASS, ECALL_SOFTWARE

SHA256_IV = bytes.fromhex(
    "6a09e667bb67ae853c6ef372a54ff53a510e527f9b05688c1f83d9ab5be0cd19")
_NR = "risc0_zkvm_platform::syscall::nr::"


def _sha_pad(nbytes: int) -> bytes:
    """SHA-256 padding for an nbytes message (message bytes excluded)."""
    blocks = (nbytes + 9 + 63) // 64
    pad = b"\x80" + b"\0" * (blocks * 64 - nbytes - 9)
    return pad + (nbytes * 8).to_bytes(8, "big")


class GuestEnv:
    """Wraps an Asm program with env-style helpers.  Layout tokens are
    ("data", off) pairs from Asm.put_data."""

    def __init__(self, a: Asm | None = None):
        self.a = a or Asm()
        self._toks: dict[str, object] = {}
        self._iv = self.a.put_data(SHA256_IV, align=8)
        # the running Assumptions digest, allocated at the first verify
        self._assumptions = None

    def _tok(self, short: str):
        t = self._toks.get(short)
        if t is None:
            t = self.a.put_data((_NR + short).encode() + b"\0")
            self._toks[short] = t
        return t

    # -- IO ----------------------------------------------------------------

    def read_slice(self, nbytes: int):
        """env::read_slice: pull nbytes of host input (stdin fd) into a
        fresh buffer; returns its token."""
        a = self.a
        buf = a.put_data(b"\0" * ((nbytes + 3) & ~3), align=4)
        a.syscall("SYS_READ", self._tok("SYS_READ"), buf, nbytes,
                  args=[0, nbytes])
        return buf

    def write_fd(self, fd: int, tok, nbytes: int):
        a = self.a
        a.syscall("SYS_WRITE", self._tok("SYS_WRITE"), 0, 0,
                  args=[fd, tok, nbytes])

    # -- hashing -------------------------------------------------------------

    def sha256_buf(self, nbytes: int):
        """Allocate a padded message buffer for an nbytes message plus an
        output state; returns (msg_tok, out_tok, nblocks).  The padding
        bytes are baked statically; runtime code fills msg[0:nbytes]."""
        a = self.a
        pad = _sha_pad(nbytes)
        msg = a.put_data(b"\0" * nbytes + pad, align=8)
        out = a.put_data(b"\0" * 32, align=8)
        return msg, out, (nbytes + len(pad)) // 64

    def sha256_emit(self, out_tok, msg_tok, nblocks: int):
        """Compress `nblocks` 64-byte blocks from the standard IV via the
        accelerator (v1 ABI ecall t0=3 -> v1compat kernel)."""
        a = self.a
        a.li("t0", 3)
        a.li("a0", out_tok)
        a.li("a1", self._iv)
        a.li("a2", msg_tok)
        a.li("a3", (msg_tok[0], msg_tok[1] + 32))
        a.li("a4", nblocks)
        a.ecall()

    # -- commit / exit ---------------------------------------------------------

    def commit(self, data_tok, nbytes: int):
        """env::commit_slice: journal `nbytes` from data_tok AND compute
        the risc0.Output digest in-guest; returns the digest token for
        halt().  The data must already sit in a sha-padded buffer from
        sha256_buf (or copy_words into one)."""
        a = self.a
        # journal write (fd 3)
        self.write_fd(3, data_tok, nbytes)
        # journal digest
        jd_msg, jd_out, nb = self.sha256_buf(nbytes)
        self.copy_words(jd_msg, data_tok, (nbytes + 3) // 4)
        self.sha256_emit(jd_out, jd_msg, nb)
        # output digest: sha256(tag || journal_digest || zeros32 || 0x0200)
        tag = hashlib.sha256(b"risc0.Output").digest()
        body = 32 + 32 + 32 + 2
        o_msg, o_out, onb = self.sha256_buf(body)
        # statics: tag at 0, zeros at 64, down-count 2 at 96
        self._patch_data(o_msg, 0, tag)
        self._patch_data(o_msg, 96, (2).to_bytes(2, "little"))
        self.copy_words((o_msg[0], o_msg[1] + 32), jd_out, 8)
        if self._assumptions is not None:
            self.copy_words((o_msg[0], o_msg[1] + 64), self._assumptions, 8)
        self.sha256_emit(o_out, o_msg, onb)
        return o_out

    def exit(self, user_exit: int = 0, out_digest_tok=None):
        self.a.halt(user_exit=user_exit, out_digest_token=out_digest_tok)

    def verify_integrity(self, claim_tok, root_tok):
        """env::verify_integrity: a RESOLVED assumption — the host must
        hold a receipt for (claim_digest, control_root) in
        `ExecutorEnv.assumptions` (reference env::verify_assumption via
        syscall/verify_integrity.rs); exec raises if none is found."""
        a = self.a
        buf = a.put_data(b"\0" * 64, align=4)
        self.copy_words(buf, claim_tok, 8)
        self.copy_words((buf[0], buf[1] + 32), root_tok, 8)
        a.syscall("SYS_VERIFY_INTEGRITY", self._tok("SYS_VERIFY_INTEGRITY"),
                  0, 0, args=[buf, 64])
        self._record_assumption(buf)

    def verify_integrity2(self, claim_tok, root_tok):
        """env::verify_integrity2: registers (claim_digest, control_root)
        as an assumption the host must resolve (syscall verify2)."""
        a = self.a
        buf = a.put_data(b"\0" * 64, align=4)
        self.copy_words(buf, claim_tok, 8)
        self.copy_words((buf[0], buf[1] + 32), root_tok, 8)
        a.syscall("SYS_VERIFY_INTEGRITY2", self._tok("SYS_VERIFY_INTEGRITY2"),
                  0, 0, args=[buf, 64])
        self._record_assumption(buf)

    def _record_assumption(self, pair_tok):
        """Fold Assumption{claim, control_root} (the 64 bytes at pair_tok)
        into the running Assumptions digest: acc <- tagged
        risc0.Assumptions(assumption, acc), the newest at the head, as
        the executor inserts it (claims.Assumptions.digest)."""
        if self._assumptions is None:
            self._assumptions = self.a.put_data(b"\0" * 32, align=8)
        a_msg, a_out, a_nb = self.sha256_buf(32 + 64 + 2)
        self._patch_data(a_msg, 0, hashlib.sha256(b"risc0.Assumption")
                         .digest())
        self._patch_data(a_msg, 96, (2).to_bytes(2, "little"))
        self.copy_words((a_msg[0], a_msg[1] + 32), pair_tok, 16)
        self.sha256_emit(a_out, a_msg, a_nb)
        l_msg, l_out, l_nb = self.sha256_buf(32 + 64 + 2)
        self._patch_data(l_msg, 0, hashlib.sha256(b"risc0.Assumptions")
                         .digest())
        self._patch_data(l_msg, 96, (2).to_bytes(2, "little"))
        self.copy_words((l_msg[0], l_msg[1] + 32), a_out, 8)
        self.copy_words((l_msg[0], l_msg[1] + 64), self._assumptions, 8)
        self.sha256_emit(l_out, l_msg, l_nb)
        self.copy_words(self._assumptions, l_out, 8)

    # -- small utils ----------------------------------------------------------

    def copy_words(self, dst_tok, src_tok, nwords: int):
        a = self.a
        a.li("t3", src_tok)
        a.li("t4", dst_tok)
        for i in range(nwords):
            a.lw("t5", "t3", 4 * i)
            a.sw("t4", "t5", 4 * i)

    def _patch_data(self, tok, off: int, blob: bytes):
        """Overwrite static bytes inside an allocated data buffer."""
        base = tok[1] + off
        self.a.data[base : base + len(blob)] = blob

    def link(self) -> bytes:
        return self.a.link()
