"""The card: kernels launched inside the traced item's root span (the
segment prove), counted from the device trace."""

from zkbench.spans import items, launches_in


def read(readings):
    got = items(readings)
    if got is None or readings.get("trace") is None:
        return None
    return launches_in(readings["trace"], got[1].root)
