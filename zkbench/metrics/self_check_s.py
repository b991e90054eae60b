"""The prover server's self-check (zkvm/prover.py): a timer around the
receipt's `Receipt.verify_integrity`, seconds an item."""

from zkbench.readings import mean_call_s


def read(readings):
    return mean_call_s(readings, "self_check")
