"""Recursion preflight of the keccak composition's own programs
(circuit/recursion/preflight.py, host Python): the `rec_preflight` scopes
inside each `lift_keccak`, `union` and `resolve` span, seconds an item."""

from zkbench.spans import mean_item_s

SPANS = ("lift_keccak", "union", "resolve")


def preflight_s(it):
    hit = [it.seconds("rec_preflight", inside=n) for n in SPANS]
    hit = [s for s in hit if s is not None]
    return sum(hit) if hit else None


def read(readings):
    return mean_item_s(readings, preflight_s)
