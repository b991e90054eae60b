"""The host verifier's check of each keccak seal before its lift
(zkvm/recursion_driver.lift_keccak, circuit/keccak/verify.py): the
`verify_keccak` spans, seconds an item."""

from zkbench.spans import mean_item_s


def read(readings):
    return mean_item_s(readings, lambda it: it.seconds("verify_keccak"))
