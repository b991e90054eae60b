"""What per-layer metric readers share: means over the window's items of
the program's perf scopes and of the harness's call timers, the card's
busy time in the traced item, and the launch counts that show the trace
kept every record of the kernels it times."""

import glob
import importlib
import json
import os

from . import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def scope_s(item, names):
    """Seconds an item spent in the named top-level perf scopes; None if
    it entered none of them."""
    scopes = item.get("scopes") or {}
    hit = [scopes[n][1] for n in names if n in scopes]
    return sum(hit) if hit else None


def mean_scope_s(readings, names):
    return mean(scope_s(it, names) for it in readings["items"])


def commit_scopes(item):
    return [p for p in item.get("scopes") or {}
            if p == "check_commit" or (p.startswith("commit_group.")
                                       and p.count(".") == 1)]


def call_s(item, name, minus_scope=None):
    """Seconds of an item's timed calls `name`, less the time of a scope
    inside them; None if the item made no such call."""
    calls = item.get("calls", {}).get(name)
    if not calls:
        return None
    total = 0.0
    for c in calls:
        total += c["s"]
        if minus_scope is not None:
            total -= c["scopes"].get(minus_scope, (0, 0.0))[1]
    return total


def call_scope_s(item, name, scope):
    calls = item.get("calls", {}).get(name)
    if not calls:
        return None
    hit = [c["scopes"][scope][1] for c in calls if scope in c["scopes"]]
    return sum(hit) if hit else None


def mean_call_s(readings, name, minus_scope=None):
    return mean(call_s(it, name, minus_scope) for it in readings["items"])


def untraced_item_s(readings):
    """Mean wall seconds of the window's items, which ran unprofiled."""
    return mean(it["s"] for it in readings["items"] if "error" not in it)


def idle_pct(readings):
    """The share of an unprofiled item in which the card idles: 1 less the
    traced item's busy seconds over the mean wall seconds of the window's
    items (the profiler lengthens the traced item's host time, not its
    device time)."""
    trace = readings["trace"]
    wall = untraced_item_s(readings)
    if trace is None or not wall:
        return None
    return 100.0 * (1.0 - trace.busy_s() / wall)


def _kernel_files():
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        with open(path) as f:
            yield json.load(f)


def kernel_names():
    """Every kernel name listed under zkbench/kernels/."""
    return [n for k in _kernel_files() for n in k["kernels"]]


def launch_groups():
    """Each {"kernels", "counters", "per_count"} listed under
    zkbench/kernels/: every count of the program's counters launches from
    per_count[0] to per_count[1] of those kernels."""
    return [g for k in _kernel_files() for g in k.get("launches", ())]


def read_counter(name: str) -> int:
    """The program's launch counter "module:function" (its `.launches`)."""
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn).launches


def launch_check(readings):
    """[(kernels, device records, counted calls, low, high)] of the traced
    item, one a launch group."""
    trace, calls = readings["trace"], readings.get("launches") or {}
    out = []
    for g in launch_groups():
        n = sum(1 for name, _s, _e in trace.ops
                if any(k in name for k in g["kernels"]))
        c = sum(calls.get(name, 0) for name in g["counters"])
        lo, hi = g["per_count"]
        out.append((g["kernels"], n, c, lo * c, hi * c))
    return out


def launches_kept(readings) -> bool:
    """Whether the trace holds, for every launch group, as many records as
    the program's counters allow."""
    return all(lo <= n <= hi for _k, n, _c, lo, hi in launch_check(readings))


def segment_roofline_pct(readings):
    """Least kernel time of the traced item's segment prove over the device
    time of the kernels that did it."""
    trace, cfg = readings["trace"], readings["config"]
    if trace is None or not launches_kept(readings):
        return None
    kernel_s = sum(trace.seconds_by_name(kernel_names()).values())
    if kernel_s <= 0:
        return None
    bound = roofline.prove_bound_s(cfg["segment_po2"], cfg["widths"],
                                   **cfg["stark"])
    return 100.0 * bound / kernel_s
