"""The window rule on a fake item and a fake clock."""

import pytest

from zkbench.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def items_of(durations, clock):
    started = []

    def item(i):
        started.append(clock())
        clock.t += durations[i]
        return {"i": i}

    return item, started


@pytest.mark.parametrize("durations, seconds, count, window", [
    ([22.0, 22.0, 22.0], 24, 2, 44.0),   # a second item starts at 22 < 24
    ([25.0, 25.0], 24, 1, 25.0),         # the first item outlasts the window
    ([10.0] * 10, 24, 3, 30.0),          # the third starts at 20, ends at 30
    ([24.0, 1.0], 24, 1, 24.0),          # none starts at exactly 24
])
def test_window_rule(durations, seconds, count, window):
    clock = Clock()
    syncs = []
    item, started = items_of(durations, clock)
    results, window_s = run_window(item, seconds, clock=clock,
                                   sync=lambda: syncs.append(clock()))
    assert len(results) == count
    assert window_s == pytest.approx(window)
    assert all(t - 100.0 < seconds for t in started)   # none starts late
    assert syncs == [100.0, 100.0 + window]             # a sync at each end
    assert [r["i"] for r in results] == list(range(count))


def test_rate_is_all_work_over_all_time():
    clock = Clock()
    item, _ = items_of([21.0, 23.0], clock)
    results, window_s = run_window(item, 24, clock=clock)
    cycles = len(results) * (1 << 20)
    assert cycles / window_s == pytest.approx(2 * (1 << 20) / 44.0)


def test_empty_window_is_refused():
    with pytest.raises(ValueError):
        run_window(lambda i: {}, 0)
