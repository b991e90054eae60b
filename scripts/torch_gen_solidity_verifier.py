#!/usr/bin/env python3
"""Generate the on-chain verifier contracts with the PyTorch port
(risc0_tpu_torch.groth16.solidity), as scripts/gen_solidity_verifier.py
does with the JAX package.

Writes OUT/Groth16Verifier.sol (the pairing check for the verifying key)
and OUT/RiscZeroGroth16Verifier.sol (the seal calldata format, the public
signals and the ReceiptClaim hashing in the contract), OUT defaulting to
contracts/.  The key is the one embedded in the golden receipt fixture
(tests/data/groth16_receipt_golden.npz), so the committed contracts match
the committed receipt; --crs takes the local CRS's key instead (the
in-process Groth16 prover's, groth16/wrap.py).

    python scripts/torch_gen_solidity_verifier.py [--crs] [--out DIR]
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def golden_vk():
    from risc0_tpu_torch.groth16 import native as nat
    from risc0_tpu_torch.groth16.verifier import VerifyingKey

    z = np.load(os.path.join(REPO, "tests", "data",
                             "groth16_receipt_golden.npz"))
    if "vk_ic" not in z.files:
        raise SystemExit("golden fixture has no embedded vk; use --crs")
    return VerifyingKey(
        alpha_g1=nat.g1_from_arr(z["vk_alpha_g1"])[0],
        beta_g2=nat.g2_from_arr(z["vk_beta_g2"])[0],
        gamma_g2=nat.g2_from_arr(z["vk_gamma_g2"])[0],
        delta_g2=nat.g2_from_arr(z["vk_delta_g2"])[0],
        ic=nat.g1_from_arr(z["vk_ic"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--crs", action="store_true",
                    help="use the local CRS vk instead of the golden's")
    ap.add_argument("--out", default=os.path.join(REPO, "contracts"))
    a = ap.parse_args(argv)

    from risc0_tpu_torch.circuit.recursion.predicates import (
        identity_p254_control_id, own_control_ids)
    from risc0_tpu_torch.groth16 import solidity as S
    from risc0_tpu_torch.groth16.wrap import verifier_parameters

    if a.crs:
        params = verifier_parameters()
        if params is None:
            raise SystemExit("no local CRS; run the groth16 wrap first")
        vk = params.vk()
    else:
        vk = golden_vk()
        params = verifier_parameters(vk)

    _ids, root = own_control_ids()
    bn254_id = identity_p254_control_id()

    os.makedirs(a.out, exist_ok=True)
    p1 = os.path.join(a.out, "Groth16Verifier.sol")
    with open(p1, "w") as f:
        f.write(S.generate_groth16_verifier(vk))
    p2 = os.path.join(a.out, "RiscZeroGroth16Verifier.sol")
    with open(p2, "w") as f:
        f.write(S.generate_risczero_verifier(root, bn254_id,
                                             params.digest()))
    print(f"wrote {p1}\nwrote {p2}")
    print(f"selector: {S.selector_from_params(params.digest()).hex()}")


if __name__ == "__main__":
    main()
