"""Constraint evaluation (circuit/ir_range.py): the share of an
unprofiled `eval_check` span in which the card idles: 1 less the card's
busy seconds inside the traced prove's span over the mean span seconds of
the window's items (the profiler lengthens the host's time, not the
card's)."""

from zkbench.spans import busy_in_s, mean_item_s, traced_span


def read(readings):
    hit = traced_span(readings, "eval_check")
    wall = mean_item_s(readings, lambda it: it.seconds("eval_check"))
    if hit is None or not wall:
        return None
    return 100.0 * (1.0 - busy_in_s(readings["trace"], hit) / wall)
