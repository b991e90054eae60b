"""The measured window: whole items back to back, one client, closed loop.

An item starts only while the window is younger than `seconds`, and every
item that started is finished, so the window is at least `seconds` long
and at most `seconds` plus one item.  Every rate or time per item is taken
over the whole window.
"""

import time


def run_window(item, seconds: float, clock=time.perf_counter,
               sync=lambda: None):
    """Run `item(i)` for i = 0, 1, ... while the window is younger than
    `seconds`; returns (results, window seconds).  `sync` is called at
    each end of the window (a device synchronisation)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s holds no item")
    results = []
    sync()
    start = clock()
    while clock() - start < seconds:
        results.append(item(len(results)))
    sync()
    return results, clock() - start
