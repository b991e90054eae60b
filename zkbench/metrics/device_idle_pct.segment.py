"""The card: the share of an unprofiled segment prove in which no kernel,
copy or set runs on it, from the traced prove's busy seconds and the
window's items' wall seconds."""

from zkbench.readings import idle_pct


def read(readings):
    return idle_pct(readings)
