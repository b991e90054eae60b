# The port's own copy of risc0_tpu/zkvm/povw_guest.py, the guest's control
# root repaired (LogBuilderGuestProver.prove).
"""PoVW Log Builder guest — the work-log update state transition proven
IN the zkVM, replacing the host-side dev-mode journal.

The reference ships this as a prebuilt Rust guest
(risc0/povw/guests/log-builder, contract in povw/src/guest.rs): read a
batch of WorkClaims, verify each as an assumption, check its nonce range
lives in this work log and starts at segment 0, verify a non-inclusion
proof that the job's slot in the sparse work-log tree is empty, insert
the job's boundary subtree, and commit a LogBuilderJournal binding
initial_commit -> updated_commit with the summed work value.

This module assembles the same contract with zkvm/guest.py's rv32im
assembler, using the SHA-256 accelerator ecall for every tree hash
(povw_tree.py hashing: node = sha256(left || right), leaf =
sha256(b"POVWLEAF" || bitmap)).  The guest is input-size generic (the
batch length is runtime data), so its image id is STABLE — the quantity
the on-chain accounting contract pins.

Input layout (encode_update_input, all little-endian):
  header (124 B): image_id(32) || work_log_id(20) || initial_commit(32)
                  || control_root(32) || n_updates(4) || is_continuation(4)
  if is_continuation: prior journal (124 B) — verified IN-GUEST as an
  assumption (ok-claim over self_image_id + journal digest), with
  prior.updated_commit == initial_commit; otherwise initial_commit must
  equal the EMPTY work-log commit (baked constant) — the reference
  State::Initial / State::Continuation contract
  (povw/guests/log-builder/src/main.rs).
  per update (2152 B):
    receipt_claim_digest(32) || nonce_min(32) || nonce_max(32) ||
    value(8) || non-inclusion path (64 siblings x 32)

Journal (124 B, povw_updater.LogBuilderJournal.encode):
  work_log_id(20) || initial_commit(32) || updated_commit(32) ||
  update_value(8) || self_image_id(32)

The self_image_id is echoed from input — a guest cannot embed its own
image id (it would change the id); the verifier checks the journal field
against the receipt's actual image id, exactly the reference pattern.
"""

from __future__ import annotations

import hashlib

from .guest import Asm
from .guest_env import GuestEnv
from .povw_tree import EMPTY_SUBTREE_ROOTS, FULL_SUBTREE_ROOTS, Job, WorkLog

HDR_BYTES = 124
PATH_SIBS = WorkLog.TREE_HEIGHT - Job.TREE_HEIGHT  # 64 siblings, level 24..88
REC_BYTES = 32 + 32 + 32 + 8 + PATH_SIBS * 32

_ELF_CACHE = None


def _off(tok, delta):
    return (tok[0], tok[1] + delta)


def log_builder_elf() -> bytes:
    """Assemble (and cache) the log-builder guest ELF."""
    global _ELF_CACHE
    if _ELF_CACHE is not None:
        return _ELF_CACHE

    g = GuestEnv()
    a = g.a

    # -- static data --------------------------------------------------------
    hdr = g.read_slice(HDR_BYTES)          # emits the header read up front
    rec = a.put_data(b"\0" * REC_BYTES, align=8)
    read_tok = g._tok("SYS_READ")

    jmsg, node, _ = g.sha256_buf(64)       # join message; node = fold state
    lmsg, _, _ = g.sha256_buf(8 + 32)      # POVWLEAF || bitmap
    g._patch_data(lmsg, 0, b"POVWLEAF")
    wmsg, work_out, wnb = g.sha256_buf(32 + 36 * 4 + 2)   # risc0.Work
    g._patch_data(wmsg, 0, hashlib.sha256(b"risc0.Work").digest())
    cmsg, wc_out, cnb = g.sha256_buf(32 + 32 + 32 + 2)    # risc0.WorkClaim
    g._patch_data(cmsg, 0, hashlib.sha256(b"risc0.WorkClaim").digest())
    g._patch_data(cmsg, 96, (2).to_bytes(2, "little"))    # down count
    cur_commit = a.put_data(b"\0" * 32, align=8)
    jbuf = a.put_data(b"\0" * 124, align=8)
    empty_tab = a.put_data(
        b"".join(EMPTY_SUBTREE_ROOTS[: Job.TREE_HEIGHT + 1]), align=8)
    full_tab = a.put_data(
        b"".join(FULL_SUBTREE_ROOTS[: Job.TREE_HEIGHT]), align=8)

    # chain binding (reference povw/guests/log-builder State::{Initial,
    # Continuation}): the initial commitment is either the EMPTY work-log
    # root (checked in-guest against a baked constant) or the
    # updated_commit of a PRIOR log-builder journal that is verified
    # in-guest as an assumption under this guest's own image id.
    empty_commit_c = a.put_data(WorkLog().commit(), align=8)
    pjmsg, pjd_out, pjnb = g.sha256_buf(124)          # prior journal
    omsg, o_out, onb = g.sha256_buf(32 + 32 + 32 + 2)  # risc0.Output
    g._patch_data(omsg, 0, hashlib.sha256(b"risc0.Output").digest())
    g._patch_data(omsg, 96, (2).to_bytes(2, "little"))
    # risc0.ReceiptClaim: tag || input(=0) || pre(=image id) || post ||
    # output || sys_exit,user_exit(=0,0) || down-count 4
    from .claims import ZERO_DIGEST, SystemState
    post_const = SystemState(0, ZERO_DIGEST).digest().tobytes()
    clmsg, cl_out, clnb = g.sha256_buf(5 * 32 + 8 + 2)
    g._patch_data(clmsg, 0, hashlib.sha256(b"risc0.ReceiptClaim").digest())
    g._patch_data(clmsg, 96, post_const)
    g._patch_data(clmsg, 168, (4).to_bytes(2, "little"))

    # header offsets
    H_IMAGE, H_LOG, H_INIT, H_ROOT, H_N, H_FLAG = 0, 32, 52, 84, 116, 120
    # record offsets
    R_CLAIM, R_NMIN, R_NMAX, R_VALUE, R_PATH = 0, 32, 64, 96, 104

    def call(label):
        a.jal("ra", label)

    # -- main ----------------------------------------------------------------
    # cur_commit <- initial_commit
    g.copy_words(cur_commit, _off(hdr, H_INIT), 8)

    # bind the chain start
    a.li("t1", _off(hdr, H_FLAG))
    a.lw("t2", "t1", 0)
    a.beq("t2", "zero", "chain_initial")
    # continuation: read the prior journal and verify it as an assumption
    a.syscall("SYS_READ", read_tok, pjmsg, 124, args=[0, 124])
    a.li("s2", _off(pjmsg, 0))            # prior work_log_id == ours
    a.li("s3", _off(hdr, H_LOG))
    a.li("s7", 5)
    call("cmp_n")
    a.li("s2", _off(pjmsg, 52))           # prior updated == our initial
    a.li("s3", _off(hdr, H_INIT))
    a.li("s7", 8)
    call("cmp_n")
    a.li("s2", _off(pjmsg, 92))           # prior self_image_id == ours
    a.li("s3", _off(hdr, H_IMAGE))
    a.li("s7", 8)
    call("cmp_n")
    g.sha256_emit(pjd_out, pjmsg, pjnb)   # journal digest
    a.li("s2", pjd_out)                   # output digest
    a.li("s3", _off(omsg, 32))
    a.li("s7", 8)
    call("copy_n")
    g.sha256_emit(o_out, omsg, onb)
    a.li("s2", _off(hdr, H_IMAGE))        # claim digest (ok-claim shape)
    a.li("s3", _off(clmsg, 64))
    a.li("s7", 8)
    call("copy_n")
    a.li("s2", o_out)
    a.li("s3", _off(clmsg, 128))
    a.li("s7", 8)
    call("copy_n")
    g.sha256_emit(cl_out, clmsg, clnb)
    g.verify_integrity(cl_out, _off(hdr, H_ROOT))
    a.jal("zero", "chain_done")
    a.label("chain_initial")              # initial: must start from EMPTY
    a.li("s2", empty_commit_c)
    a.li("s3", cur_commit)
    a.li("s7", 8)
    call("cmp_n")
    a.label("chain_done")

    a.li("t1", _off(hdr, H_N))
    a.lw("s0", "t1", 0)                   # s0 = n_updates
    a.li("s10", 0)                        # total value lo
    a.li("s11", 0)                        # total value hi
    a.beq("s0", "zero", "finish")

    a.label("update_loop")
    a.syscall("SYS_READ", read_tok, rec, REC_BYTES, args=[0, REC_BYTES])

    # nonce layout (LE bytes): segment = word0, job = words 1-2,
    # log = words 3-7 (povw.PovwNonce.to_u256: log<<96 | job<<32 | segment)
    a.li("s2", _off(rec, R_NMIN + 12))    # nmin.log
    a.li("s3", _off(hdr, H_LOG))
    a.li("s7", 5)
    call("cmp_n")
    a.li("s2", _off(rec, R_NMAX + 12))    # nmax.log
    a.li("s3", _off(hdr, H_LOG))
    a.li("s7", 5)
    call("cmp_n")
    a.li("s2", _off(rec, R_NMIN + 4))     # nmin.job == nmax.job
    a.li("s3", _off(rec, R_NMAX + 4))
    a.li("s7", 2)
    call("cmp_n")
    a.li("t1", _off(rec, R_NMIN))         # nmin.segment == 0
    a.lw("t2", "t1", 0)
    a.bne("t2", "zero", "fail")

    # Work digest: tag || u16-halves-as-words(nmin||nmax||value) || 0x0000
    a.li("s2", _off(rec, R_NMIN))
    a.li("s3", _off(wmsg, 32))
    a.li("s7", 16)                        # nmin+nmax = 16 words -> 32 halves
    call("halves")
    a.li("s2", _off(rec, R_VALUE))
    a.li("s3", _off(wmsg, 32 + 128))
    a.li("s7", 2)
    call("halves")
    g.sha256_emit(work_out, wmsg, wnb)

    # WorkClaim digest: tag || receipt_claim_digest || work_digest || 0x0200
    a.li("s2", _off(rec, R_CLAIM))
    a.li("s3", _off(cmsg, 32))
    a.li("s7", 8)
    call("copy_n")
    a.li("s2", work_out)
    a.li("s3", _off(cmsg, 64))
    a.li("s7", 8)
    call("copy_n")
    g.sha256_emit(wc_out, cmsg, cnb)

    # env::verify_assumption on the work claim (host-resolved receipt)
    g.verify_integrity(wc_out, _off(hdr, H_ROOT))

    # non-inclusion: fold EMPTY[24] along the path; must equal cur_commit
    a.li("s2", _off(empty_tab, Job.TREE_HEIGHT * 32))
    a.li("s3", node)
    a.li("s7", 8)
    call("copy_n")
    a.li("t1", _off(rec, R_NMIN + 4))
    a.lw("s5", "t1", 0)                   # job lo
    a.lw("s6", "t1", 4)                   # job hi
    a.li("s4", _off(rec, R_PATH))
    a.li("s7", PATH_SIBS)
    call("fold_path")
    a.li("s2", node)
    a.li("s3", cur_commit)
    a.li("s7", 8)
    call("cmp_n")

    # boundary subtree of Job(index_max = nmax.segment) -> node
    a.li("t1", _off(rec, R_NMAX))
    a.lw("s9", "t1", 0)
    call("job_commit")

    # fold the inserted job up the same path -> new commitment
    a.li("t1", _off(rec, R_NMIN + 4))
    a.lw("s5", "t1", 0)
    a.lw("s6", "t1", 4)
    a.li("s4", _off(rec, R_PATH))
    a.li("s7", PATH_SIBS)
    call("fold_path")
    a.li("s2", node)
    a.li("s3", cur_commit)
    a.li("s7", 8)
    call("copy_n")

    # total += value (u64)
    a.li("t1", _off(rec, R_VALUE))
    a.lw("t2", "t1", 0)
    a.lw("t3", "t1", 4)
    a.add("s10", "s10", "t2")
    a.sltu("t4", "s10", "t2")             # carry
    a.add("s11", "s11", "t3")
    a.add("s11", "s11", "t4")

    a.addi("s0", "s0", -1)
    a.bne("s0", "zero", "update_loop")

    # -- journal -------------------------------------------------------------
    a.label("finish")
    a.li("s2", _off(hdr, H_LOG))
    a.li("s3", jbuf)
    a.li("s7", 5)
    call("copy_n")
    a.li("s2", _off(hdr, H_INIT))
    a.li("s3", _off(jbuf, 20))
    a.li("s7", 8)
    call("copy_n")
    a.li("s2", cur_commit)
    a.li("s3", _off(jbuf, 52))
    a.li("s7", 8)
    call("copy_n")
    a.li("t1", _off(jbuf, 84))
    a.sw("t1", "s10", 0)
    a.sw("t1", "s11", 4)
    a.li("s2", _off(hdr, H_IMAGE))
    a.li("s3", _off(jbuf, 92))
    a.li("s7", 8)
    call("copy_n")
    dig = g.commit(jbuf, 124)
    g.exit(0, dig)

    a.label("fail")
    a.halt(1)

    # -- subroutines ----------------------------------------------------------
    # sha_join: node <- sha256(mem[s2..+32] || mem[s3..+32])      (leaf)
    a.label("sha_join")
    a.li("t1", jmsg)
    for i in range(8):
        a.lw("t2", "s2", 4 * i)
        a.sw("t1", "t2", 4 * i)
    for i in range(8):
        a.lw("t2", "s3", 4 * i)
        a.sw("t1", "t2", 32 + 4 * i)
    g.sha256_emit(node, jmsg, 2)
    a.jalr("zero", "ra")

    # fold_path: fold `node` up s7 levels along siblings at s4, 64-bit
    # index in s5/s6 selecting left/right (povw_tree SubtreeOpening.root)
    a.label("fold_path")
    a.add("s1", "ra", "zero")
    a.label("fold_loop")
    a.andi("t1", "s5", 1)
    a.beq("t1", "zero", "fold_even")
    a.add("s2", "s4", "zero")             # odd: node is the right child
    a.li("s3", node)
    call("sha_join")
    a.jal("zero", "fold_next")
    a.label("fold_even")
    a.li("s2", node)
    a.add("s3", "s4", "zero")
    call("sha_join")
    a.label("fold_next")
    a.srli("s5", "s5", 1)                 # 64-bit index >>= 1
    a.slli("t1", "s6", 31)
    a.or_("s5", "s5", "t1")
    a.srli("s6", "s6", 1)
    a.addi("s4", "s4", 32)
    a.addi("s7", "s7", -1)
    a.bne("s7", "zero", "fold_loop")
    a.jalr("zero", "s1")

    # job_commit: node <- Job(index_max = s9).commit()
    # (povw_tree.Job._boundary_subtree_root: leaf of the boundary bitmap,
    # then 24 levels joining FULL below / EMPTY above the boundary)
    a.label("job_commit")
    a.add("s1", "ra", "zero")
    a.andi("t1", "s9", 0xFF)
    a.addi("t1", "t1", 1)                 # m = bits set in the leaf bitmap
    a.li("t2", _off(lmsg, 8))
    a.li("t3", 32)
    a.label("bm_loop")
    a.li("t4", 8)
    a.sltu("t5", "t1", "t4")
    a.bne("t5", "zero", "bm_partial")
    a.li("t6", 0xFF)
    a.sb("t2", "t6", 0)
    a.addi("t1", "t1", -8)
    a.jal("zero", "bm_next")
    a.label("bm_partial")
    a.li("t6", 1)
    a.sll("t6", "t6", "t1")
    a.addi("t6", "t6", -1)
    a.sb("t2", "t6", 0)
    a.li("t1", 0)
    a.label("bm_next")
    a.addi("t2", "t2", 1)
    a.addi("t3", "t3", -1)
    a.bne("t3", "zero", "bm_loop")
    g.sha256_emit(node, lmsg, 1)
    a.srli("s9", "s9", 8)
    a.li("s7", Job.TREE_HEIGHT)
    a.li("s8", 0)                         # table byte offset
    a.label("jc_loop")
    a.andi("t1", "s9", 1)
    a.beq("t1", "zero", "jc_even")
    a.li("s2", full_tab)                  # odd: left = FULL[i]
    a.add("s2", "s2", "s8")
    a.li("s3", node)
    call("sha_join")
    a.jal("zero", "jc_next")
    a.label("jc_even")
    a.li("s2", node)                      # even: right = EMPTY[i]
    a.li("s3", empty_tab)
    a.add("s3", "s3", "s8")
    call("sha_join")
    a.label("jc_next")
    a.srli("s9", "s9", 1)
    a.addi("s8", "s8", 32)
    a.addi("s7", "s7", -1)
    a.bne("s7", "zero", "jc_loop")
    a.jalr("zero", "s1")

    # halves: expand s7 words at s2 into u16-halves-as-words at s3  (leaf)
    a.label("halves")
    a.lw("t1", "s2", 0)
    a.slli("t2", "t1", 16)
    a.srli("t2", "t2", 16)
    a.sw("s3", "t2", 0)
    a.srli("t2", "t1", 16)
    a.sw("s3", "t2", 4)
    a.addi("s2", "s2", 4)
    a.addi("s3", "s3", 8)
    a.addi("s7", "s7", -1)
    a.bne("s7", "zero", "halves")
    a.jalr("zero", "ra")

    # copy_n: copy s7 words s2 -> s3                                (leaf)
    a.label("copy_n")
    a.lw("t1", "s2", 0)
    a.sw("s3", "t1", 0)
    a.addi("s2", "s2", 4)
    a.addi("s3", "s3", 4)
    a.addi("s7", "s7", -1)
    a.bne("s7", "zero", "copy_n")
    a.jalr("zero", "ra")

    # cmp_n: compare s7 words s2 vs s3, halt(1) on mismatch         (leaf)
    a.label("cmp_n")
    a.lw("t1", "s2", 0)
    a.lw("t2", "s3", 0)
    a.bne("t1", "t2", "fail")
    a.addi("s2", "s2", 4)
    a.addi("s3", "s3", 4)
    a.addi("s7", "s7", -1)
    a.bne("s7", "zero", "cmp_n")
    a.jalr("zero", "ra")

    _ELF_CACHE = g.link()
    return _ELF_CACHE


class LogBuilderGuestProver:
    """Journal prover that RUNS the log-builder guest in the zkVM —
    the replacement for povw_updater's dev-mode host-side journal.

    With `prover=None` the guest is executed (the full state transition,
    assumption verification included, runs in the emulator) and the
    journal receipt is a dev-mode FakeReceipt over the REAL executed
    session claim.  With a ProverServer the guest segment is proven and
    the returned receipt is cryptographic (the reference's
    risc0-povw-log-builder.bin flow, povw/src/prover.rs:207-231)."""

    is_guest_prover = True

    def __init__(self, prover=None, segment_po2: int = 17):
        self.prover = prover
        self.segment_po2 = segment_po2
        self._image_id = None

    def image_id(self):
        if self._image_id is None:
            from .exec import ExecutorEnv, ExecutorImpl

            self._image_id = ExecutorImpl(
                ExecutorEnv(), log_builder_elf()).compute_image_id()
        return self._image_id

    def prove(self, *, log_id, initial_commit, updates, work_receipts,
              continuation=None):
        """continuation: (prior_journal_bytes, prior_receipt) chaining a
        non-empty log; the prior receipt is added as an assumption so the
        guest's in-guest journal verification resolves."""
        import numpy as np

        from .exec import ExecutorEnv, ExecutorImpl
        from .povw import WorkError

        root = None
        for r in work_receipts:
            r_root = getattr(r, "control_root", None)
            r_root = (np.zeros(8, np.uint32) if r_root is None
                      else np.asarray(r_root, np.uint32))
            if root is not None and r_root.tobytes() != root.tobytes():
                raise WorkError(
                    "one update batch must share a control root")
            root = r_root

        # The guest assumes every claim under the zero control root, which
        # names the verifier's own allowed root: the only root that the
        # resolve program discharges (it fixes the head assumption's
        # control root to zero).  The JAX package hands the guest the
        # receipts' own root instead, so a batch of succinct receipts is
        # assumed under a root that its resolve cannot discharge, and a
        # continuation's prior receipt, registered under zero, is not
        # found (ROADMAP.md queue 3).  The batch still shares one root.
        zero = np.zeros(8, np.uint32)
        prior_journal = None
        assumed = list(work_receipts)
        if continuation is not None:
            prior_journal, prior_receipt = continuation
            assumed.append(prior_receipt)
        data = encode_update_input(self.image_id(), log_id, initial_commit,
                                   zero, updates,
                                   prior_journal=prior_journal)
        env = ExecutorEnv(segment_po2=self.segment_po2).write_slice(data)
        for r in assumed:
            env.add_assumption(r, control_root=zero)
        elf = log_builder_elf()

        if self.prover is not None:
            info = self.prover.prove(env, elf)
            receipt = info.receipt if hasattr(info, "receipt") else info
            receipt.verify(self.image_id())
            return receipt

        from .receipt import FakeReceipt, InnerReceipt, Receipt, session_claim

        session = ExecutorImpl(env, elf).run()
        if session.exit_code != ("Halted", 0):
            raise WorkError(
                f"log-builder guest rejected the update: {session.exit_code}")
        return Receipt(inner=InnerReceipt("fake",
                                          FakeReceipt(session_claim(session))),
                       journal=session.journal)


def encode_update_input(image_id, work_log_id: int, initial_commit: bytes,
                        control_root, updates,
                        prior_journal: bytes | None = None) -> bytes:
    """Build the guest's stdin.  `updates` is a list of
    (receipt_claim_digest_32B, nonce_min_32B, nonce_max_32B, value,
    path_list_of_64_siblings); `prior_journal` chains a continuation
    (the guest verifies it in-guest; without it the initial commit must
    be the EMPTY work-log root)."""
    import numpy as np

    out = np.asarray(image_id, np.uint32).tobytes()
    out += int(work_log_id).to_bytes(20, "little")
    out += bytes(initial_commit)
    out += np.asarray(control_root, np.uint32).tobytes()
    out += len(updates).to_bytes(4, "little")
    out += (0 if prior_journal is None else 1).to_bytes(4, "little")
    if prior_journal is not None:
        assert len(prior_journal) == 124, "prior journal must be 124 bytes"
        out += bytes(prior_journal)
    for claim_digest, nmin, nmax, value, path in updates:
        assert len(path) == PATH_SIBS, "non-inclusion path must be level 24"
        out += bytes(claim_digest) + bytes(nmin) + bytes(nmax)
        out += int(value).to_bytes(8, "little")
        out += b"".join(bytes(p) for p in path)
    return out
