"""One run of one cell: set-up, the measured window, the readings, the
comparison with the plain reference, and the result line.

    python zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from the window's items (call
timers and the program's perf scopes) and from one more item traced on
the card after the window.  Either way every item's output is judged by
the reference once the window has closed.
"""

import argparse
import gc
import json
import os
import sys
import time

from . import manifest
from .window import run_window

FORBIDDEN = ("jax", "jaxlib", "flax", "risc0_tpu")


class Refused(Exception):
    """The run cannot measure: no card, or fewer than the cell needs."""


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (risc0_tpu_torch is the port, risc0_tpu is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} found")
    return "cuda"


class Context:
    """What a traffic kind is given: the cell, its configuration and mix, the
    seed and the device."""

    def __init__(self, cell, seed, device):
        self.cell = cell
        self.config = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.device = device
        self.root = cell.root


def run(workload, seed, seconds, trace, root, t_start, device=None):
    """Measure one run; returns (result dict, check lines).  `device`
    None looks for a card and refuses without one."""
    cell = manifest.Cell(root, workload)
    if device is None:
        device = card(cell.chips)
    import torch

    on_card = device.startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    ctx = Context(cell, seed, device)
    traffic = cell.traffic_module().Traffic(ctx)
    traffic.setup()
    if trace:
        traffic.install_timers(sync)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    results, window_s = run_window(traffic.item, seconds, sync=sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    extra = {}
    notes = []
    if trace:
        from . import devtrace, readings as reading

        log = devtrace.ScopeLog()
        perf = traffic.perf_module()
        counters = sorted({n for g in reading.launch_groups()
                           for n in g["counters"]})
        before = {n: reading.read_counter(n) for n in counters}
        with devtrace.logging_perf_scopes(perf, log):
            traffic.span = log.span
            if on_card:
                traced, dtrace = devtrace.trace_call(
                    lambda: traffic.item(len(results)))
            else:
                traced, dtrace = traffic.item(len(results)), None
        readings = {"items": results, "trace": dtrace,
                    "config": cell.config,
                    "launches": {n: reading.read_counter(n) - before[n]
                                 for n in counters}}
        if dtrace is not None:
            notes.append(f"traced item {traced['s']} s, window items "
                         f"{reading.untraced_item_s(readings)} s")
            for kernels, n, c, lo, hi in reading.launch_check(readings):
                notes.append(f"launches {'/'.join(kernels)}: {n} traced, "
                             f"{c} counted calls allow {lo}-{hi}")
        for m in cell.per_layer():
            v = cell.metric_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace is not None:
            extra["busy_s"] = dtrace.busy_s()
            extra["window_s"] = dtrace.window_s
            extra["breakdown"] = devtrace.breakdown(dtrace, log)
        results = results + [traced]
    else:
        values = dict(traffic.end_to_end(results, window_s))
        values["setup_s"] = setup_s
        values["peak_gib"] = peak / 2**30
        for m in cell.end_to_end():
            if m["name"] not in values:
                raise KeyError(f"{workload}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    traffic.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = traffic.judge(results)
    failed = sum(1 for r in results if r.get("error"))
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    if "busy_s" in extra:
        device_info["busy_s"] = extra["busy_s"]
        device_info["window_s"] = extra["window_s"]
    result = {"correct": correct, "attempted": len(results), "failed": failed,
              "metrics": metrics, "device": device_info,
              "items_s": [r["s"] for r in results]}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    lines = notes + [f"check {k}: {v} (limit {lim})"
                     for k, (v, lim) in checks.items()]
    return result, lines


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(manifest.HERE)
    try:
        result, lines = run(args.workload, args.seed, args.seconds,
                            args.trace, root, t_start)
    except Refused as e:
        print(f"zkbench: refused: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"zkbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
