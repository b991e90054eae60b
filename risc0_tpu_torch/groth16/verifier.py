"""Groth16 verifier over BN254 (counterpart of
``risc0_tpu/groth16/verifier.py``; reference risc0/groth16/src/verifier.rs).

Checks e(A, B) == e(alpha, beta) * e(L, gamma) * e(C, delta) with
L = IC_0 + sum_i input_i * IC_i, via one multi-Miller loop + shared final
exponentiation.  The default verifying key is the public risc0-ethereum
Groth16Verifier.sol ceremony (verifier.rs:34-75); public inputs for receipt
verification are [a0, a1, c0, c1, id_bn254] from split control-root/claim
digests (verifier.rs:92-106).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from . import bn254 as bn


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list


def _g1(x, y):
    pt = (int(x) % bn.P, int(y) % bn.P)
    if not bn.g1_is_on_curve(pt):
        raise ValueError("G1 point not on curve")
    return pt


def _g2(x1, x2, y1, y2):
    """Constants convention (verifier.rs try_verifying_key +
    g2_from_bytes): c0 = X2, c1 = X1."""
    pt = ((int(x2) % bn.P, int(x1) % bn.P), (int(y2) % bn.P, int(y1) % bn.P))
    if not bn.g2_is_on_curve(pt):
        raise ValueError("G2 point not on twist")
    return pt


# risc0-ethereum Groth16Verifier.sol ceremony constants (verifier.rs:34-75)
GROTH16_VERIFIER_KEY = VerifyingKey(
    alpha_g1=_g1(
        20491192805390485299153009773594534940189261866228447918068658471970481763042,
        9383485363053290200918347156157836566562967994039712273449902621266178545958),
    beta_g2=_g2(
        4252822878758300859123897981450591353533073413197771768651442665752259397132,
        6375614351688725206403948262868962793625744043794305715222011528459656738731,
        21847035105528745403288232691147584728191162732299865338377159692350059136679,
        10505242626370262277552901082094356697409835680220590971873171140371331206856),
    gamma_g2=_g2(
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
        8495653923123431417604973247489272438418190587263600148770280649306958101930),
    delta_g2=_g2(
        1668323501672964604911431804142266013250380587483576094566949227275849579036,
        12043754404802191763554326994664886008979042643626290185762540825416902247219,
        7710631539206257456743780535472368339139328733484942210876916214502466455394,
        13740680757317479711909903993315946540841369848973133181051452051592786724563),
    ic=[
        _g1(8446592859352799428420270221449902464741693648963397251242447530457567083492,
            1064796367193003797175961162477173481551615790032213185848276823815288302804),
        _g1(3179835575189816632597428042194253779818690147323192973511715175294048485951,
            20895841676865356752879376687052266198216014795822152491318012491767775979074),
        _g1(5332723250224941161709478398807683311971555792614491788690328996478511465287,
            21199491073419440416471372042641226693637837098357067793586556692319371762571),
        _g1(12457994489566736295787256452575216703923664299075106359829199968023158780583,
            19706766271952591897761291684837117091856807401404423804318744964752784280790),
        _g1(19617808913178163826953378459323299110911217259216006187355745713323154132237,
            21663537384585072695701846972542344484111393047775983928357046779215877070466),
        _g1(6834578911681792552110317589222010969491336870276623105249474534788043166867,
            15060583660288623605191393599883223885678013570733629274538391874953353488393),
    ],
)


class Verifier:
    """reference verifier.rs:78-201."""

    def __init__(self, a_g1, b_g2, c_g1, public_inputs,
                 vk: VerifyingKey = GROTH16_VERIFIER_KEY):
        if not (bn.g1_is_on_curve(a_g1) and bn.g1_is_on_curve(c_g1)):
            raise ValueError("proof G1 point not on curve")
        if not bn.g2_is_on_curve(b_g2):
            raise ValueError("proof G2 point not on twist")
        if len(public_inputs) != len(vk.ic) - 1:
            raise ValueError(f"{len(public_inputs)} public inputs for "
                             f"{len(vk.ic) - 1} key inputs")
        self.a, self.b, self.c = a_g1, b_g2, c_g1
        self.inputs = [int(x) % bn.R for x in public_inputs]
        self.vk = vk

    @staticmethod
    def from_seal(seal_bytes: bytes, control_root, claim_digest,
                  bn254_control_id, vk: VerifyingKey = GROTH16_VERIFIER_KEY):
        """256-byte big-endian seal (types.rs Seal::decode: a | b as
        (x.c1,x.c0,y.c1,y.c0) | c) + receipt digests -> Verifier."""
        if len(seal_bytes) != 256:
            raise ValueError("bad groth16 seal length")
        w = [int.from_bytes(seal_bytes[32 * i: 32 * i + 32], "big")
             for i in range(8)]
        a = (w[0], w[1])
        b = ((w[3], w[2]), (w[5], w[4]))
        c = (w[6], w[7])
        a0, a1 = split_digest(control_root)
        c0, c1 = split_digest(claim_digest)
        id_fr = int.from_bytes(
            np.asarray(bn254_control_id, np.uint32).tobytes()[::-1], "big")
        return Verifier(a, b, c, [a0, a1, c0, c1, id_fr], vk)

    @staticmethod
    def from_json(proof, public_inputs, vk_json):
        """snarkjs-format JSON objects (types.rs ProofJson/VerifyingKeyJson:
        pi_b rows are [c0, c1])."""
        def g2j(rows):
            return ((int(rows[0][0]) % bn.P, int(rows[0][1]) % bn.P),
                    (int(rows[1][0]) % bn.P, int(rows[1][1]) % bn.P))

        a = (int(proof["pi_a"][0]), int(proof["pi_a"][1]))
        b = g2j(proof["pi_b"])
        c = (int(proof["pi_c"][0]), int(proof["pi_c"][1]))
        vk = verifying_key_from_json(vk_json)
        return Verifier(a, b, c, [int(v) for v in public_inputs], vk)

    def verify(self) -> bool:
        L = self.vk.ic[0]
        for coeff, pt in zip(self.inputs, self.vk.ic[1:]):
            L = bn.g1_add(L, bn.g1_mul(pt, coeff))
        return bn.multi_pairing_is_one([
            (bn.g1_neg(self.a), self.b),
            (self.vk.alpha_g1, self.vk.beta_g2),
            (L, self.vk.gamma_g2),
            (self.c, self.vk.delta_g2),
        ])


def verifying_key_from_json(vk_json) -> VerifyingKey:
    def g2j(rows):
        return ((int(rows[0][0]) % bn.P, int(rows[0][1]) % bn.P),
                (int(rows[1][0]) % bn.P, int(rows[1][1]) % bn.P))

    return VerifyingKey(
        alpha_g1=(int(vk_json["vk_alpha_1"][0]), int(vk_json["vk_alpha_1"][1])),
        beta_g2=g2j(vk_json["vk_beta_2"]),
        gamma_g2=g2j(vk_json["vk_gamma_2"]),
        delta_g2=g2j(vk_json["vk_delta_2"]),
        ic=[(int(p[0]), int(p[1])) for p in vk_json["IC"]],
    )


def hash_g1(pt) -> np.ndarray:
    """sha256(x_be || y_be) (verifier.rs hash_point: uncompressed y,x LE
    reversed)."""
    x, y = pt
    return _sha_words(int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big"))


def hash_g2(pt) -> np.ndarray:
    """sha256(x.c1 || x.c0 || y.c1 || y.c0, each BE)."""
    (xc0, xc1), (yc0, yc1) = pt
    return _sha_words(
        int(xc1).to_bytes(32, "big") + int(xc0).to_bytes(32, "big")
        + int(yc1).to_bytes(32, "big") + int(yc0).to_bytes(32, "big"))


def _sha_words(b: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint32).copy()


def vk_digest(vk: VerifyingKey) -> np.ndarray:
    """Digestible for VerifyingKey (verifier.rs:214-233)."""
    from ..zkvm.claims import tagged_list, tagged_struct

    ic = tagged_list("risc0_groth16.VerifyingKey.IC",
                     [hash_g1(p) for p in vk.ic])
    return tagged_struct(
        "risc0_groth16.VerifyingKey",
        [hash_g1(vk.alpha_g1), hash_g2(vk.beta_g2), hash_g2(vk.gamma_g2),
         hash_g2(vk.delta_g2), ic], [])


def proof_json_to_seal(proof) -> bytes:
    """snarkjs ProofJson -> 256-byte seal (reference types.rs
    Seal::from_json).  Layout mirrors Verifier.from_seal: a.x a.y |
    b.x.c1 b.x.c0 b.y.c1 b.y.c0 | c.x c.y, each 32-byte big-endian;
    pi_b rows are [c0, c1]."""
    a, b, c = proof["pi_a"], proof["pi_b"], proof["pi_c"]
    w = [int(a[0]), int(a[1]),
         int(b[0][1]), int(b[0][0]),
         int(b[1][1]), int(b[1][0]),
         int(c[0]), int(c[1])]
    return b"".join(x.to_bytes(32, "big") for x in w)


def split_digest(digest) -> tuple[int, int]:
    """Digest -> (lower-half Fr, upper-half Fr) (verifier.rs:302-310):
    byte-reverse to big-endian, split in the middle, each half as BE."""
    be = np.asarray(digest, np.uint32).tobytes()[::-1]
    return (int.from_bytes(be[16:], "big"), int.from_bytes(be[:16], "big"))


def fr_digest(value: int) -> np.ndarray:
    """Tagged digest of an Fr public input (verifier.rs Digestible for Fr)."""
    from ..zkvm.claims import tagged_struct

    be = int(value).to_bytes(32, "little")[::-1]
    words = np.frombuffer(be, np.uint32)
    return tagged_struct("risc0_groth16.Fr", [words], [])


def digest_as_fr_pair(digest):
    return split_digest(digest)
