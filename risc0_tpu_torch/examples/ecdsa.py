"""ECDSA example (reference examples/ecdsa/methods/guest/src/main.rs):
the guest verifies a secp256k1 ECDSA signature in the zkVM and commits
(verifying key, message digest) to the journal, so the receipt proves
"this public key signed this message" without revealing anything else.

Where the reference accelerates the RustCrypto `k256` crate through the
bigint2 patch set, this guest drives the released bigint2 bibc blobs
directly through the BIGINT2 ecall (platform syscall.rs:1051-1116):
modinv/modmul over the group order for (s^-1, u1, u2) and a 256-bit
double-and-add over ec_add_256/ec_double_256 for u1*G + u2*Q, all
assembled with zkvm/guest.py.  At the default message the session is two
segments of po2 17.

    python -m risc0_tpu_torch.examples.ecdsa [message] [--device cpu]
    RISC0_REAL_PROVE=1 python -m risc0_tpu_torch.examples.ecdsa
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

from ..assets import BIGINT2_DATA
from ..zkvm.exec import ExecutorEnv, ExecutorImpl
from ..zkvm.guest_env import GuestEnv
from .common import composite_prover, parse_args, real_prove, verifier_ctx

MESSAGE = "this message was signed, and a zkVM checked it"
SEGMENT_PO2 = 17

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

_BLOBS = Path(BIGINT2_DATA)


def _le(x: int, nbytes: int = 32) -> bytes:
    return int(x).to_bytes(nbytes, "little")


# ---- host-side curve math (keygen + sign only; verify runs in-guest) -----

def _ec_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % P == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return (x, (lam * (p[0] - x) - p[1]) % P)


def _ec_mul(k, pt):
    acc = None
    for bit in bin(k)[2:]:
        acc = _ec_add(acc, acc)
        if bit == "1":
            acc = _ec_add(acc, pt)
    return acc


def _sign(priv: int, z: int) -> tuple[int, int]:
    """Deterministic nonce (hash of key||digest — an RFC6979 stand-in)."""
    k = int.from_bytes(
        hashlib.sha256(_le(priv) + _le(z)).digest(), "big") % N
    r = _ec_mul(k, G)[0] % N
    s = pow(k, -1, N) * (z + r * priv) % N
    return r, s


# ---- guest builder ----------------------------------------------------------

def _blob(a, name):
    """Vendor a bibc blob into the data section; precompute the section
    pointers the BIGINT2 ecall takes (header: nondet/verify/consts/temp
    word counts, then bytecode)."""
    raw = (_BLOBS / (name + ".blob")).read_bytes()
    nondet, verify, _consts, temp = struct.unpack("<4I", raw[:16])
    tok = a.put_data(raw, align=16)
    return {"tok": tok, "verify_off": 16 + nondet * 4,
            "consts_off": 16 + (nondet + verify) * 4,
            "temp_bytes": temp * 4}


def _off(tok, d):
    return (tok[0], tok[1] + d)


def _bigint(a, b, args):
    """Emit one BIGINT2 ecall: t1/t2/t3 = program sections, a1.. = operand
    pointers (token, or a register name to move from), temp arena on sp."""
    tok = b["tok"]
    a.li("t0", 6)  # ecall::BIGINT2
    a.li("a0", tok)
    a.li("t1", _off(tok, 16))
    a.li("t2", _off(tok, b["verify_off"]))
    a.li("t3", _off(tok, b["consts_off"]))
    for i, val in enumerate(args):
        if isinstance(val, str):
            a.addi(f"a{1 + i}", val, 0)
        else:
            a.li(f"a{1 + i}", val)
    a.li("t4", b["temp_bytes"])
    a.sub("sp", "sp", "t4")
    a.ecall()
    a.li("t4", b["temp_bytes"])
    a.add("sp", "sp", "t4")


def _copy(a, dst_tok, src_tok, nwords):
    a.li("t3", src_tok)
    a.li("t4", dst_tok)
    for i in range(nwords):
        a.lw("t5", "t3", 4 * i)
        a.sw("t4", "t5", 4 * i)


def _require_nonzero(a, tok, fail_label, tag):
    """OR the 8 words at tok; branch to fail if all zero."""
    a.li("t3", tok)
    a.li("t4", 0)
    for i in range(8):
        a.lw("t5", "t3", 4 * i)
        a.or_("t4", "t4", "t5")
    a.beq("t4", "zero", fail_label)


def build_guest(msg_len: int) -> bytes:
    """Guest: read (msg, Q, r, s); z = sha256(msg) as a scalar;
    verify r == x(u1*G + u2*Q) mod n; commit (Q, digest)."""
    g = GuestEnv()
    a = g.a
    a.li("sp", 0x200400)

    blobs = {k: _blob(a, k) for k in (
        "field/modinv_256", "field/modmul_256", "field/modadd_256",
        "ec/ec_add_256", "ec/ec_double_256")}
    curve = a.put_data(_le(P) + _le(0) + _le(7), align=16)
    order = a.put_data(_le(N), align=16)
    zero32 = a.put_data(b"\0" * 32, align=16)
    gpt = a.put_data(_le(G[0]) + _le(G[1]), align=16)
    # working buffers
    z_raw = a.put_data(b"\0" * 32, align=16)
    z_s = a.put_data(b"\0" * 32, align=16)
    sinv = a.put_data(b"\0" * 32, align=16)
    u1 = a.put_data(b"\0" * 32, align=16)
    u2 = a.put_data(b"\0" * 32, align=16)
    acc = a.put_data(b"\0" * 64, align=16)
    tmp = a.put_data(b"\0" * 64, align=16)
    p1 = a.put_data(b"\0" * 64, align=16)
    p2 = a.put_data(b"\0" * 64, align=16)
    rpt = a.put_data(b"\0" * 64, align=16)
    rx = a.put_data(b"\0" * 32, align=16)

    # inputs: message into a sha-padded buffer, then Q (x||y LE), r, s
    msg, dig, nblocks = g.sha256_buf(msg_len)
    a.syscall("SYS_READ", g._tok("SYS_READ"), msg, msg_len,
              args=[0, msg_len])
    q = g.read_slice(64)
    r_in = g.read_slice(32)
    s_in = g.read_slice(32)

    # z = sha256(msg) interpreted big-endian, reduced mod n
    g.sha256_emit(dig, msg, nblocks)
    a.li("t3", dig)
    a.li("t4", z_raw)
    for i in range(32):
        a.lbu("t5", "t3", i)
        a.sb("t4", "t5", 31 - i)
    _bigint(a, blobs["field/modadd_256"], [z_raw, zero32, order, z_s])

    _require_nonzero(a, r_in, "fail", "r")
    _require_nonzero(a, s_in, "fail", "s")

    # u1 = z / s, u2 = r / s  (mod n)
    _bigint(a, blobs["field/modinv_256"], [s_in, order, sinv])
    _bigint(a, blobs["field/modmul_256"], [z_s, sinv, order, u1])
    _bigint(a, blobs["field/modmul_256"], [r_in, sinv, order, u2])

    # p1 = u1*G, p2 = u2*Q  (scalar_mul: a5=scalar, a6=point, a7=out;
    # returns s4 = accumulator-is-identity)
    a.li("a5", u1)
    a.li("a6", gpt)
    a.li("a7", p1)
    a.jal("ra", "scalar_mul")
    a.add("s6", "s4", "zero")  # save p1_inf
    a.li("a5", u2)
    a.li("a6", q)
    a.li("a7", p2)
    a.jal("ra", "scalar_mul")
    # r != 0 was checked, so u2 != 0 and p2 is a real point
    a.bne("s4", "zero", "fail")
    a.bne("s6", "zero", "use_p2")  # u1 == 0 mod n -> R = p2

    # R = p1 + p2: same x means doubling (y equal) or identity (fail)
    a.li("t3", p1)
    a.li("t4", p2)
    for i in range(8):
        a.lw("t5", "t3", 4 * i)
        a.lw("t6", "t4", 4 * i)
        a.bne("t5", "t6", "x_differs")
    for i in range(8, 16):
        a.lw("t5", "t3", 4 * i)
        a.lw("t6", "t4", 4 * i)
        a.bne("t5", "t6", "fail")  # p1 == -p2: R is the identity
    _bigint(a, blobs["ec/ec_double_256"], [p1, curve, rpt])
    a.jal("zero", "have_r")
    a.label("x_differs")
    _bigint(a, blobs["ec/ec_add_256"], [p1, p2, curve, rpt])
    a.jal("zero", "have_r")
    a.label("use_p2")
    _copy(a, rpt, p2, 16)
    a.label("have_r")

    # accept iff x(R) mod n == r
    _bigint(a, blobs["field/modadd_256"], [rpt, zero32, order, rx])
    a.li("t3", rx)
    a.li("t4", r_in)
    for i in range(8):
        a.lw("t5", "t3", 4 * i)
        a.lw("t6", "t4", 4 * i)
        a.bne("t5", "t6", "fail")

    # journal = Qx || Qy || digest
    jbuf = a.put_data(b"\0" * 96, align=8)
    _copy(a, jbuf, q, 16)
    _copy(a, _off(jbuf, 64), dig, 8)
    out = g.commit(jbuf, 96)
    g.exit(0, out)
    a.label("fail")
    g.exit(1)

    # ---- scalar_mul: left-to-right double-and-add over the accelerator.
    # (Like the reference's AffinePoint::mul, x-equal adds abort: the
    # ec_add blob's nondet 1/(x2-x1) cannot verify — probability ~2^-255
    # for honest inputs.)
    a.label("scalar_mul")
    a.li("s3", 1)    # acc is the identity
    a.li("s2", 255)  # bit index
    a.label("sm_loop")
    a.bne("s3", "zero", "sm_bit")
    _bigint(a, blobs["ec/ec_double_256"], [acc, curve, tmp])
    _copy(a, acc, tmp, 16)
    a.label("sm_bit")
    a.srli("t4", "s2", 5)
    a.slli("t4", "t4", 2)
    a.add("t4", "a5", "t4")
    a.lw("t4", "t4", 0)
    a.andi("t5", "s2", 31)
    a.srl("t4", "t4", "t5")
    a.andi("t4", "t4", 1)
    a.beq("t4", "zero", "sm_next")
    a.bne("s3", "zero", "sm_set")
    _bigint(a, blobs["ec/ec_add_256"], [acc, "a6", curve, tmp])
    _copy(a, acc, tmp, 16)
    a.jal("zero", "sm_next")
    a.label("sm_set")  # acc <- point (from register a6)
    a.li("t4", acc)
    for i in range(16):
        a.lw("t5", "a6", 4 * i)
        a.sw("t4", "t5", 4 * i)
    a.li("s3", 0)
    a.label("sm_next")
    a.addi("s2", "s2", -1)
    a.li("t4", -1)
    a.bne("s2", "t4", "sm_loop")
    # copy acc -> (a7); return s4 = is_identity
    a.li("t3", acc)
    for i in range(16):
        a.lw("t5", "t3", 4 * i)
        a.sw("a7", "t5", 4 * i)
    a.add("s4", "s3", "zero")
    a.jalr("zero", "ra", 0)

    return g.link()


def stdin_for(message: bytes, priv: int) -> tuple[bytes, tuple[int, int]]:
    """The guest's input for `message` signed by `priv`: message, Q
    (x||y), r, s, all little-endian; and the public key Q."""
    z = int.from_bytes(hashlib.sha256(message).digest(), "big") % N
    qx, qy = _ec_mul(priv, G)
    r, s = _sign(priv, z)
    return message + _le(qx) + _le(qy) + _le(r) + _le(s), (qx, qy)


def example_key() -> int:
    return int.from_bytes(hashlib.sha256(b"example key").digest(), "big") % N


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, lambda ap: ap.add_argument(
        "message", nargs="?", default=MESSAGE))
    message = args.message.encode()
    stdin, (qx, qy) = stdin_for(message, example_key())
    print(f"pubkey x: {qx:064x}")
    print(f"sig r:    {int.from_bytes(stdin[-64:-32], 'little'):064x}")

    elf = build_guest(len(message))
    executor = ExecutorImpl(
        ExecutorEnv(segment_po2=SEGMENT_PO2).write_slice(stdin), elf)
    image_id = executor.compute_image_id()
    session = executor.run()
    assert session.exit_code == ("Halted", 0), \
        f"in-guest verification failed: {session.exit_code}"
    journal = bytes(session.journal)
    assert journal == _le(qx) + _le(qy) + hashlib.sha256(message).digest()
    print(f"guest accepted the signature "
          f"({session.user_cycles} user cycles)")

    # a bad signature must be rejected in-guest
    bad = bytearray(stdin)
    bad[-1] ^= 1
    bad_sess = ExecutorImpl(
        ExecutorEnv(segment_po2=SEGMENT_PO2).write_slice(bytes(bad)),
        elf).run()
    assert bad_sess.exit_code == ("Halted", 1), bad_sess.exit_code
    print("guest rejected a tampered signature")

    real = real_prove()
    info = composite_prover(args.device, real).prove_session(session)
    info.receipt.verify(image_id, verifier_ctx(real))
    print(f"receipt verified (kind={info.receipt.inner.kind}); journal "
          f"binds (pubkey, sha256(message))")
    return {"elf": elf, "image_id": image_id, "session": session,
            "rejected": bad_sess, "receipt": info.receipt,
            "pubkey": (qx, qy), "message": message}


if __name__ == "__main__":
    main()
