"""The card: the share of an unprofiled receipt in which no kernel, copy
or set runs on it, from the traced receipt's busy seconds and the
window's items' wall seconds."""

from zkbench.readings import idle_pct


def read(readings):
    return idle_pct(readings)
