"""BENCHMARK.json and the files it names, found by name.

- a configuration: the `file` of its `configs` entry (zkbench/configs/)
- a traffic mix: zkbench/workloads/<traffic>.json, which names its kind
- a traffic kind (what an item is): zkbench/traffic/<kind>.py
- a guest's inputs: zkbench/guests/<guest>.py, named by the configuration
- a per-layer metric: zkbench/metrics/<metric name>.py

Adding a cell, configuration, mix or metric adds files and entries here;
no file of the harness changes.
"""

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, name: str):
    """Import the file at `path` as a module named `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads`, with everything it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.bench_dir = os.path.join(root, "zkbench")
        with open(os.path.join(self.bench_dir, "workloads",
                               self.entry["traffic"] + ".json")) as f:
            self.mix = json.load(f)

    def _applies(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it,
        and those that list no cells and move an end-to-end metric of it."""
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in moved)]

    def traffic_module(self):
        d = self.mix["kind"]
        return load_module(os.path.join(self.bench_dir, "traffic", d + ".py"),
                           f"zkbench_traffic_{d}")

    def guest_module(self):
        g = self.config["guest"]
        return load_module(os.path.join(self.bench_dir, "guests", g + ".py"),
                           f"zkbench_guest_{g}")

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        name + ".py"),
                           "zkbench_metric_" + name.replace(".", "_"))
