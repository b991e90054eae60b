"""The plain reference against the repository's fixture seals: it accepts
them, reads their claims, and rejects a seal with one word changed."""

import os

import numpy as np
import pytest

from zkbench.reference import circuits, claims, secp256k1, stark

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "tests", "data")


@pytest.fixture(scope="module")
def rv32im_seal():
    return np.load(os.path.join(DATA, "rv32im_seal_po2_14.npy"))


@pytest.fixture(scope="module")
def lift_seal():
    return np.load(os.path.join(DATA, "recursion_seal_lift14.npy"))


def test_rv32im_seal_and_claim(rv32im_seal):
    g, po2 = stark.verify(rv32im_seal[1:], circuits.rv32im())
    assert po2 == 14
    with open(os.path.join(DATA, "rv32im_seal_po2_14.claim_digest")) as f:
        want = f.read().strip()
    assert claims.segment_receipt_claim(claims.segment_claim(g)).hex() == want


def test_recursion_seal_and_claim(lift_seal, rv32im_seal):
    ids, root = claims.allowed_set()
    seen = []
    g, po2 = stark.verify(lift_seal, circuits.recursion(),
                          lambda p, code: seen.append(code))
    assert po2 == 18 and seen == [ids["lift_rv32im_14"]]
    got_root, digest = claims.recursion_output(g)
    assert got_root == root
    seg, _ = stark.verify(rv32im_seal[1:], circuits.rv32im())
    assert digest == claims.segment_receipt_claim(claims.segment_claim(seg))


@pytest.mark.parametrize("where", ["header", "middle", "last"])
@pytest.mark.parametrize("which", ["rv32im", "recursion"])
def test_changed_word_rejected(where, which, rv32im_seal, lift_seal):
    seal = (rv32im_seal[1:] if which == "rv32im" else lift_seal).copy()
    circuit = circuits.rv32im() if which == "rv32im" else circuits.recursion()
    at = {"header": 3, "middle": len(seal) // 2, "last": len(seal) - 1}[where]
    seal[at] = (int(seal[at]) + 1) % (15 * 2**27 + 1)
    with pytest.raises(stark.Rejected):
        stark.verify(seal, circuit)


@pytest.mark.parametrize("cut", [1, 8])
def test_short_or_long_seal_rejected(cut, rv32im_seal):
    with pytest.raises(stark.Rejected):
        stark.verify(rv32im_seal[1:-cut], circuits.rv32im())
    with pytest.raises(stark.Rejected):
        stark.verify(np.concatenate([rv32im_seal[1:],
                                     rv32im_seal[1:1 + cut]]),
                     circuits.rv32im())


def test_ecdsa_reference():
    priv = 0x1234567890ABCDEF
    q = secp256k1.mul(priv, secp256k1.G)
    assert secp256k1.on_curve(q)
    import hashlib
    msg = b"m" * 46
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % secp256k1.N
    k = 0xC0FFEE
    r = secp256k1.mul(k, secp256k1.G)[0] % secp256k1.N
    s = pow(k, -1, secp256k1.N) * (z + r * priv) % secp256k1.N
    assert secp256k1.verify(msg, q, r, s)
    assert not secp256k1.verify(msg, q, r, s ^ 1)
    assert not secp256k1.verify(msg + b"x", q, r, s)
    assert secp256k1.journal(msg, q)[-32:] == hashlib.sha256(msg).digest()


CONFIGS = ["loop_po2_20", "ecdsa_k256"]


def _elfs(name):
    import json

    with open(os.path.join(ROOT, "zkbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    out = []
    for key in ("elf", "kernel_elf"):
        with open(os.path.join(ROOT, cfg[key]), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_image_id_agrees_with_executor(name):
    """The reference's image ID of a configuration's ELFs is the one the
    port's executor computes for them."""
    from risc0_tpu_torch.zkvm.exec import ExecutorEnv, ExecutorImpl
    from zkbench.reference import image

    user, kernel = _elfs(name)
    want = ExecutorImpl(ExecutorEnv(), user, kernel).compute_image_id()
    assert image.image_id(user, kernel) == bytes(
        np.asarray(want, np.uint32).tobytes())


@pytest.mark.parametrize("part", ["elf", "kernel_elf"])
def test_image_id_changes_with_a_byte(part):
    """A byte changed inside a loaded segment changes the image ID."""
    import struct

    from zkbench.reference import image

    user, kernel = _elfs("loop_po2_20")
    want = image.image_id(user, kernel)
    elf = bytearray(user if part == "elf" else kernel)
    phoff, = struct.unpack_from("<I", elf, 28)
    phentsize, phnum = struct.unpack_from("<HH", elf, 42)
    # the largest loaded segment (the user's words overlay the kernel's
    # below 0xC0000000)
    loads = [struct.unpack_from("<5I", elf, phoff + i * phentsize)
             for i in range(phnum)]
    _t, offset, _v, _p, filesz = max((h for h in loads if h[0] == 1),
                                     key=lambda h: h[4])
    elf[offset + filesz // 2] ^= 1
    got = (image.image_id(bytes(elf), kernel) if part == "elf"
           else image.image_id(user, bytes(elf)))
    assert got != want
