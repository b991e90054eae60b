"""On-chain leg of the SNARK wrap: Solidity verifier generation + the
calldata seal format (counterpart of ``risc0_tpu/groth16/solidity.py``).

The reference ships a snarkjs-generated Groth16 verifier contract
(groth16_proof/groth16/verifier.sol in the reference repository) and
risc0-ethereum wraps it with a RiscZeroGroth16Verifier that derives the five public
signals from (control root, claim digest, BN254 control id).  This
module generates the equivalent pair of contracts for the IN-REPO
verifying key (our stark_verify R1CS + CRS), and implements the calldata
seal format: `bytes4 selector ++ 256-byte proof`, selector =
bytes4(verifier parameters digest) — so a receipt can be checked against
the deployed verifier it targets.

The contracts are plain Solidity (EVM precompiles ecAdd 0x06 / ecMul
0x07 / pairing 0x08), written fresh rather than snarkjs yul codegen.
Round-trip tests parse the generated source back into a VerifyingKey and
re-run the pairing check in Python (groth16/bn254.py), and check the
in-Solidity ReceiptClaim hashing layout against zkvm.claims byte-for-byte
via the python model functions below.
"""

from __future__ import annotations

import re

import numpy as np

from . import bn254 as bn
from .verifier import VerifyingKey

SEAL_BYTES = 256


# ---------------------------------------------------------------------------
# calldata seal format (reference risc0-ethereum seal: selector ++ proof)
# ---------------------------------------------------------------------------

def selector_from_params(params_digest) -> bytes:
    """bytes4 verifier selector = first 4 bytes of the verifier
    parameters digest (big-endian byte order of the digest words)."""
    return np.asarray(params_digest, np.uint32).tobytes()[:4]


def seal_to_calldata(seal_bytes: bytes, params_digest) -> bytes:
    if len(seal_bytes) != SEAL_BYTES:
        raise ValueError("bad groth16 seal length")
    return selector_from_params(params_digest) + bytes(seal_bytes)


def decode_calldata(calldata: bytes, params_digest=None):
    """-> (selector, a, b, c) with the proof points as python ints in the
    contract's argument layout (b rows are [c1, c0])."""
    if len(calldata) != 4 + SEAL_BYTES:
        raise ValueError("bad calldata seal length")
    sel, body = calldata[:4], calldata[4:]
    if params_digest is not None and sel != selector_from_params(
            params_digest):
        raise ValueError("seal selector does not match verifier parameters")
    w = [int.from_bytes(body[32 * i: 32 * i + 32], "big") for i in range(8)]
    return sel, (w[0], w[1]), ((w[2], w[3]), (w[4], w[5])), (w[6], w[7])


# ---------------------------------------------------------------------------
# python models of the in-contract hashing (keep in lockstep with the
# Solidity below; asserted against zkvm.claims in tests)
# ---------------------------------------------------------------------------

def _sha(b: bytes) -> bytes:
    import hashlib

    return hashlib.sha256(b).digest()

_SYSTEM_STATE_ZERO = None


def sol_system_state_zero() -> bytes:
    """SystemState{pc: 0, merkle_root: 0}.digest() as the contract
    constant (reference claim/receipt.rs:168-171 pruned post state)."""
    global _SYSTEM_STATE_ZERO
    if _SYSTEM_STATE_ZERO is None:
        _SYSTEM_STATE_ZERO = _sha(
            _sha(b"risc0.SystemState") + b"\x00" * 32 +
            (0).to_bytes(4, "little") + (1).to_bytes(2, "little"))
    return _SYSTEM_STATE_ZERO


def sol_output_digest(journal_digest: bytes, assumptions: bytes) -> bytes:
    return _sha(_sha(b"risc0.Output") + journal_digest + assumptions +
                (2).to_bytes(2, "little"))


def sol_ok_claim_digest(image_id: bytes, journal_digest: bytes) -> bytes:
    """ReceiptClaim::ok digest as the RiscZeroGroth16Verifier contract
    computes it (mirror of zkvm.claims.receipt_claim_ok)."""
    zero = b"\x00" * 32
    output = sol_output_digest(journal_digest, zero)
    return _sha(_sha(b"risc0.ReceiptClaim") + zero + image_id +
                sol_system_state_zero() + output +
                (0).to_bytes(4, "little") + (0).to_bytes(4, "little") +
                (4).to_bytes(2, "little"))


# ---------------------------------------------------------------------------
# source generation
# ---------------------------------------------------------------------------

_HEADER = """\
// SPDX-License-Identifier: Apache-2.0
// GENERATED by scripts/gen_solidity_verifier.py from the in-repo CRS
// (risc0_tpu/groth16) — do not edit by hand.
pragma solidity ^0.8.9;
"""


def generate_groth16_verifier(vk: VerifyingKey) -> str:
    """Groth16 pairing-check contract for `vk` (functional equivalent of
    the reference's snarkjs verifier.sol, written as plain Solidity over
    the ecAdd/ecMul/pairing precompiles)."""
    if len(vk.ic) != 6:
        raise ValueError("expected 5 public signals")
    (ax, ay) = vk.alpha_g1

    def g2c(pt):
        # storage order (x1, x2, y1, y2) = (c1, c0) pairs, matching the
        # pairing precompile operand order (EIP-197)
        (x0, x1), (y0, y1) = pt
        return (x1, x0, y1, y0)

    b = g2c(vk.beta_g2)
    g = g2c(vk.gamma_g2)
    d = g2c(vk.delta_g2)
    ic_lines = "\n".join(
        f"    uint256 constant IC{i}x = {x};\n"
        f"    uint256 constant IC{i}y = {y};" for i, (x, y) in
        enumerate(vk.ic))

    return _HEADER + f"""
contract Groth16Verifier {{
    // BN254 scalar / base field moduli
    uint256 constant r = {bn.R};
    uint256 constant q = {bn.P};

    uint256 constant alphax = {ax};
    uint256 constant alphay = {ay};
    uint256 constant betax1 = {b[0]};
    uint256 constant betax2 = {b[1]};
    uint256 constant betay1 = {b[2]};
    uint256 constant betay2 = {b[3]};
    uint256 constant gammax1 = {g[0]};
    uint256 constant gammax2 = {g[1]};
    uint256 constant gammay1 = {g[2]};
    uint256 constant gammay2 = {g[3]};
    uint256 constant deltax1 = {d[0]};
    uint256 constant deltax2 = {d[1]};
    uint256 constant deltay1 = {d[2]};
    uint256 constant deltay2 = {d[3]};

{ic_lines}

    function _ecAdd(uint256[4] memory input) private view
        returns (uint256[2] memory out)
    {{
        bool ok;
        assembly {{
            ok := staticcall(gas(), 6, input, 128, out, 64)
        }}
        require(ok, "ecAdd failed");
    }}

    function _ecMul(uint256 x, uint256 y, uint256 s) private view
        returns (uint256[2] memory out)
    {{
        uint256[3] memory input = [x, y, s];
        bool ok;
        assembly {{
            ok := staticcall(gas(), 7, input, 96, out, 64)
        }}
        require(ok, "ecMul failed");
    }}

    /// verifyProof(a, b, c, pubSignals): b rows are (c1, c0) pairs.
    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata bPt,
        uint256[2] calldata c,
        uint256[5] calldata pubSignals
    ) public view returns (bool) {{
        for (uint256 i = 0; i < 5; i++) {{
            require(pubSignals[i] < r, "signal not in field");
        }}
        // L = IC0 + sum_i pubSignals[i] * IC_{{i+1}}
        uint256[2] memory L = [IC0x, IC0y];
        uint256[5][2] memory ic = [
            [IC1x, IC2x, IC3x, IC4x, IC5x],
            [IC1y, IC2y, IC3y, IC4y, IC5y]
        ];
        for (uint256 i = 0; i < 5; i++) {{
            uint256[2] memory t = _ecMul(ic[0][i], ic[1][i], pubSignals[i]);
            L = _ecAdd([L[0], L[1], t[0], t[1]]);
        }}
        // e(-A, B) * e(alpha, beta) * e(L, gamma) * e(C, delta) == 1
        uint256[24] memory input = [
            a[0], (q - (a[1] % q)) % q,
            bPt[0][0], bPt[0][1], bPt[1][0], bPt[1][1],
            alphax, alphay,
            betax1, betax2, betay1, betay2,
            L[0], L[1],
            gammax1, gammax2, gammay1, gammay2,
            c[0], c[1],
            deltax1, deltax2, deltay1, deltay2
        ];
        uint256[1] memory out;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, input, 768, out, 32)
        }}
        return ok && out[0] == 1;
    }}
}}
"""


def generate_risczero_verifier(control_root, bn254_control_id,
                               params_digest) -> str:
    """RiscZeroGroth16Verifier-equivalent wrapper: derives the five
    public signals from (CONTROL_ROOT, claim digest, BN254 control id),
    computes ok-claim digests in-contract (ReceiptClaimLib layout =
    zkvm.claims tagged structs), and checks the seal's bytes4 selector."""
    root_be = np.asarray(control_root, np.uint32).tobytes()
    id_be = np.asarray(bn254_control_id, np.uint32).tobytes()[::-1]
    sel = selector_from_params(params_digest)
    state_zero = sol_system_state_zero()

    return _HEADER + f"""
import {{Groth16Verifier}} from "./Groth16Verifier.sol";

/// Verifies RISC Zero-style Groth16 receipt seals against the in-repo
/// verifying key.  Seal calldata format: bytes4 selector ++ 256-byte
/// proof (a | b as (c1,c0) pairs | c), selector =
/// bytes4(verifier parameters digest).
contract RiscZeroGroth16Verifier is Groth16Verifier {{
    // allowed recursion-program set root (Poseidon2 words, LE bytes)
    bytes32 public constant CONTROL_ROOT = bytes32(hex"{root_be.hex()}");
    // identity_p254 program id over BN254 (big-endian uint256)
    uint256 public constant BN254_CONTROL_ID = {int.from_bytes(id_be, "big")};
    bytes4 public constant SELECTOR = bytes4(hex"{sel.hex()}");

    bytes32 private constant SYSTEM_STATE_ZERO_DIGEST =
        bytes32(hex"{state_zero.hex()}");
    bytes32 private constant ZERO = bytes32(0);

    error SelectorMismatch(bytes4 got, bytes4 want);
    error SealLength();
    error VerificationFailed();

    /// reverse the 32 bytes of `v` (digest words are little-endian on
    /// the zkVM side; Fr public signals want big-endian halves)
    function _reverse(uint256 v) private pure returns (uint256 out) {{
        for (uint256 i = 0; i < 32; i++) {{
            out = (out << 8) | ((v >> (8 * i)) & 0xff);
        }}
    }}

    function _splitDigest(bytes32 digest)
        private pure returns (uint256 lo, uint256 hi)
    {{
        uint256 rev = _reverse(uint256(digest));
        lo = rev & ((1 << 128) - 1);
        hi = rev >> 128;
    }}

    function _outputDigest(bytes32 journalDigest, bytes32 assumptions)
        private pure returns (bytes32)
    {{
        return sha256(abi.encodePacked(
            sha256("risc0.Output"), journalDigest, assumptions,
            uint16(0x0200)  // down-count 2, little-endian
        ));
    }}

    /// ReceiptClaim::ok(imageId, journalDigest).digest()
    function okClaimDigest(bytes32 imageId, bytes32 journalDigest)
        public pure returns (bytes32)
    {{
        bytes32 output = _outputDigest(journalDigest, ZERO);
        return sha256(abi.encodePacked(
            sha256("risc0.ReceiptClaim"),
            ZERO,                       // input (zero digest)
            imageId,                    // pre (pruned)
            SYSTEM_STATE_ZERO_DIGEST,   // post (Halted -> zeroed state)
            output,
            uint32(0), uint32(0),       // sysExit, userExit (LE)
            uint16(0x0400)              // down-count 4, little-endian
        ));
    }}

    function verifyIntegrity(bytes calldata seal, bytes32 claimDigest)
        public view
    {{
        if (seal.length != 260) revert SealLength();
        bytes4 sel = bytes4(seal[0:4]);
        if (sel != SELECTOR) revert SelectorMismatch(sel, SELECTOR);
        uint256[8] memory w;
        for (uint256 i = 0; i < 8; i++) {{
            w[i] = uint256(bytes32(seal[4 + 32 * i: 36 + 32 * i]));
        }}
        (uint256 r0, uint256 r1) = _splitDigest(CONTROL_ROOT);
        (uint256 c0, uint256 c1) = _splitDigest(claimDigest);
        bool ok = this.verifyProof(
            [w[0], w[1]],
            [[w[2], w[3]], [w[4], w[5]]],
            [w[6], w[7]],
            [r0, r1, c0, c1, BN254_CONTROL_ID]);
        if (!ok) revert VerificationFailed();
    }}

    function verify(bytes calldata seal, bytes32 imageId,
                    bytes32 journalDigest) external view
    {{
        verifyIntegrity(seal, okClaimDigest(imageId, journalDigest));
    }}
}}
"""


def parse_vk_from_sol(text: str) -> VerifyingKey:
    """Recover the VerifyingKey from generated Groth16Verifier source
    (round-trip check that the emitted constants are faithful)."""
    vals = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"uint256 constant (\w+) = (\d+);", text)}

    def g2(p):
        # stored (x1=c1, x2=c0, y1=c1, y2=c0) -> ((c0, c1), (c0, c1))
        return ((vals[p + "x2"], vals[p + "x1"]),
                (vals[p + "y2"], vals[p + "y1"]))

    n = 0
    while f"IC{n}x" in vals:
        n += 1
    return VerifyingKey(
        alpha_g1=(vals["alphax"], vals["alphay"]),
        beta_g2=g2("beta"), gamma_g2=g2("gamma"), delta_g2=g2("delta"),
        ic=[(vals[f"IC{i}x"], vals[f"IC{i}y"]) for i in range(n)])
