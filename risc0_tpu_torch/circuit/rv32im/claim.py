"""Decode the ReceiptClaim and the PoVW Work record of an rv32im segment
seal from its globals (counterpart of ``decode_claim`` and ``decode_work``
in ``risc0_tpu/circuit/rv32im/claim.py``).

Reference: risc0/circuit/rv32im/src/lib.rs:116-177 (Rv32imV2Claim::decode),
risc0/zkvm/src/claim/receipt.rs:154-190 (decode_from_seal_v2) and
claim/receipt.rs:310-324 (exit code from terminate state).  The 90 global
registers are addressed through the extracted LAYOUT_GLOBAL tree; digests
are stored as 16-bit shorts (low, high per word).
"""

from __future__ import annotations

import numpy as np

from ... import field as F
from ...zkvm.claims import ExitCode, MaybePruned, ReceiptClaim, SystemState
from ...zkvm.povw import PovwNonce, Work
from ..layout import rv32im_global_layout
from .circuit import OUTPUT_SIZE
from .verify import RV32IM_SEAL_VERSION


def decode_claim(seal) -> ReceiptClaim:
    """Decode the claim committed by an rv32im segment seal."""
    seal = np.asarray(seal, np.uint32)
    if seal[0] != RV32IM_SEAL_VERSION:
        raise ValueError("seal version mismatch")
    g = F.decode_np(seal[1 : 1 + OUTPUT_SIZE])  # standard-form values
    lay = rv32im_global_layout()

    pre_state = lay.state_in.read_digest(g)
    post_state = lay.state_out.read_digest(g)
    input_digest = lay.input.read_digest(g)
    output_digest = lay.output.read_digest(g)
    is_terminate = lay.is_terminate.read(g)

    exit_code = ExitCode("SystemSplit")
    output = MaybePruned.from_digest(np.zeros(8, np.uint32))
    if is_terminate == 1:
        # HighLowU16(user_exit, halt_type): high half = user exit code,
        # low half = halt type (0 terminate, 1 pause)
        a0_high = lay.term_a0high.read(g)
        a0_low = lay.term_a0low.read(g)
        if a0_low == 0:
            exit_code = ExitCode("Halted", a0_high)
        elif a0_low == 1:
            exit_code = ExitCode("Paused", a0_high)
        else:
            raise ValueError(f"illegal halt type {a0_low}")
        output = MaybePruned.from_digest(output_digest)

    # on Halted the decoded post state is the zero digest
    # (claim/receipt.rs:168-171)
    post_digest = np.zeros(8, np.uint32) if exit_code.kind == "Halted" \
        else post_state

    return ReceiptClaim(
        pre=MaybePruned.of(SystemState(0, pre_state)),
        post=MaybePruned.of(SystemState(0, post_digest)),
        exit_code=exit_code,
        input=MaybePruned.from_digest(input_digest),
        output=output,
    )


def decode_work(seal) -> Work:
    """The PoVW Work record that lift_rv32im_povw_{po2} emits for this
    seal: the one nonce of the povw_nonce globals as its range, and
    value = cycles proved = 1 << po2 (reference recursion/prove/
    zkr.rs:70-76)."""
    seal = np.asarray(seal, np.uint32)
    if seal[0] != RV32IM_SEAL_VERSION:
        raise ValueError("seal version mismatch")
    g = F.decode_np(seal[1 : 1 + OUTPUT_SIZE])
    po2 = int(seal[1 + OUTPUT_SIZE])
    halfs = []
    for pair in rv32im_global_layout().povw_nonce.values:
        halfs.extend([pair.low.read(g), pair.high.read(g)])
    if any(h >= 1 << 16 for h in halfs):
        raise ValueError("nonce short out of range")
    nonce = PovwNonce.from_u16s(halfs)
    return Work(nonce_min=nonce, nonce_max=nonce, value=1 << po2)
