"""A cell, a traffic mix, a configuration and a per-layer metric added as
files (and entries of BENCHMARK.json) in a copy are found by name, with
no file of the harness edited."""

import json
import os
import shutil

import pytest

from zkbench import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def copy(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "zkbench"), tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def harness_files(root):
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "zkbench")):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_added_files_are_found(copy):
    before = harness_files(copy)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    # a configuration, a mix of an existing traffic kind, a cell and a metric
    cfg = json.loads((copy / "zkbench/configs/ecdsa_k256.json").read_text())
    cfg["name"] = "ecdsa_k256_b"
    (copy / "zkbench/configs/ecdsa_k256_b.json").write_text(json.dumps(cfg))
    (copy / "zkbench/workloads/composite.json").write_text(json.dumps(
        {"kind": "receipt", "receipt_kind": "composite", "why": "test"}))
    (copy / "zkbench/metrics/launches_per_item.py").write_text(
        "def read(readings):\n    return 42.0\n")
    bench["configs"].append({"name": "ecdsa_k256_b", "source": "x",
                             "file": "zkbench/configs/ecdsa_k256_b.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ecdsa.composite",
                               "config": "ecdsa_k256_b",
                               "traffic": "composite", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][1]["workloads"].append("ecdsa.composite")
    bench["per_layer"].append({"name": "launches_per_item", "unit": "count",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels", "moves": "receipt_s",
                               "workloads": ["ecdsa.composite"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.Cell(str(copy), "ecdsa.composite")
    assert cell.config["name"] == "ecdsa_k256_b"
    assert cell.mix["receipt_kind"] == "composite"
    assert cell.traffic_module().Traffic.__name__ == "Traffic"
    assert [m["name"] for m in cell.end_to_end()] == [
        "receipt_s", "peak_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer()] == ["launches_per_item"]
    assert cell.metric_reader("launches_per_item").read({}) == 42.0
    assert harness_files(copy) == {
        **before, "zkbench/metrics/launches_per_item.py":
        b"def read(readings):\n    return 42.0\n"}


@pytest.mark.parametrize("cell, metrics", [
    ("loop20.segment", ["witgen_exec_s", "witgen_accum_s", "eval_check_s",
                        "commit_s", "deep_fri_s", "kernel_roofline_pct",
                        "device_idle_pct.segment"]),
    ("ecdsa.succinct", ["executor_s", "segment_prove_s", "rec_preflight_s",
                        "rec_prove_s", "self_check_s",
                        "device_idle_pct.receipt"]),
])
def test_every_metric_of_a_cell_has_its_reader(cell, metrics):
    c = manifest.Cell(ROOT, cell)
    assert [m["name"] for m in c.per_layer()] == metrics
    for name in metrics:
        assert callable(c.metric_reader(name).read)
    assert "setup_s" in [m["name"] for m in c.end_to_end()]
