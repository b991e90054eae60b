"""The ecdsa example's guest (risc0_tpu_torch.examples.ecdsa.build_guest):
it reads a message, a secp256k1 public key Q and a signature (r, s),
verifies the signature through the bigint2 accelerator and commits
(Qx, Qy, sha256(message)), or halts with exit code 1.  This module makes
its inputs: a key and a message drawn from the seed, signed with a
deterministic nonce."""

import hashlib
import os

import numpy as np

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


def elf(root: str, config) -> bytes:
    """The guest as built by the example's build_guest at the configured
    message length, kept as a file so that the cell's work is fixed."""
    with open(os.path.join(root, config["elf"]), "rb") as f:
        return f.read()


def _add(p, q):
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


def _mul(k, pt):
    acc = None
    for bit in bin(k)[2:]:
        acc = _add(acc, acc)
        if bit == "1":
            acc = _add(acc, pt)
    return acc


def _le(x: int) -> bytes:
    return x.to_bytes(32, "little")


def inputs(config, rng: np.random.Generator) -> dict:
    """{"stdin": the guest's input, "message", "q", "r", "s"}."""
    message = rng.integers(0, 256, config["message_len"],
                           dtype=np.uint8).tobytes()
    priv = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    q = _mul(priv, G)
    z = int.from_bytes(hashlib.sha256(message).digest(), "big") % N
    k = int.from_bytes(hashlib.sha256(_le(priv) + _le(z)).digest(),
                       "big") % N or 1
    r = _mul(k, G)[0] % N
    s = pow(k, -1, N) * (z + r * priv) % N
    return {"stdin": message + _le(q[0]) + _le(q[1]) + _le(r) + _le(s),
            "message": message, "q": q, "r": r, "s": s}
