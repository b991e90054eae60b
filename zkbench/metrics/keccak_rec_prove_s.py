"""Recursion proving of the keccak composition's own programs
(zkvm/recursion_driver.py, circuit/recursion/prove.py): each
`lift_keccak` span less its `verify_keccak` and `rec_preflight`, and the
`union` and `resolve` spans less their `rec_preflight`, seconds an
item."""

from zkbench.spans import mean_item_s


def prove_s(it):
    hit = [it.seconds("lift_keccak", minus="verify_keccak"),
           it.seconds("rec_preflight", inside="lift_keccak"),
           it.seconds("union", minus="rec_preflight"),
           it.seconds("resolve", minus="rec_preflight")]
    if hit[0] is None and hit[2] is None and hit[3] is None:
        return None
    lift, pre, union, resolve = (s or 0.0 for s in hit)
    return lift - pre + union + resolve


def read(readings):
    return mean_item_s(readings, prove_s)
