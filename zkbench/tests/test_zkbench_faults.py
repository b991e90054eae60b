"""A whole run of the segment cell on the CPU, at a size a test can hold
(segments of po2 15), with the look for a card skipped: sound, it reads
`correct` true; with the timed path broken underneath, or with the
control planted, it reads false.

The faults a segment cell can have: a prove that returns its state
unchanged (the previous seal) and an answer altered where it is produced
(a word of the seal).  It has no batch to halve and no exchange between
cards.  Proves are memoized by their inputs, so the runs share them.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from zkbench import control, harness
from zkbench.window import run_window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "loop15.segment"
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of the benchmark with a po2 15 configuration and its cell."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "zkbench"), root / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "zkbench/configs/loop_po2_20.json").read_text())
    cfg.update(name="loop_po2_15", segment_po2=15)
    (root / "zkbench/configs/loop_po2_15.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "loop_po2_15", "source": "test",
                             "file": "zkbench/configs/loop_po2_15.json",
                             "reduced": ["segment_po2"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "loop_po2_15",
                               "traffic": "segment", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "loop20.segment" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture(scope="module")
def memo():
    """prove_segment, memoized by (pre-state, rand_z, FRI queries), with
    the constraint evaluation chunked and the accum witgen on the host,
    which the CPU proves faster."""
    from risc0_tpu_torch.circuit.rv32im import prove as rv_prove
    from risc0_tpu_torch.prove import fri

    inner = rv_prove.prove_segment
    cache = {}

    def prove_segment(seg, rand_z=None, **kw):
        key = (bytes(np.asarray(seg.pre_digest, np.uint32)), tuple(rand_z),
               fri.QUERIES)
        if key not in cache:
            cache[key] = np.asarray(inner(seg, rand_z=rand_z,
                                          eval_chunk=4096, accum="host",
                                          **kw))
        return cache[key].copy()

    return inner, prove_segment


def one_item_window(item, seconds, sync):
    """The window rule on a clock that counts items: one item, whatever
    the memoized proves take."""
    done = []

    def counted(i):
        done.append(i)
        return item(i)

    return run_window(counted, 1.0, clock=lambda: float(len(done)),
                      sync=sync)


def run_with(tree, monkeypatch, prove):
    from risc0_tpu_torch.circuit.rv32im import prove as rv_prove

    monkeypatch.setattr(rv_prove, "prove_segment", prove)
    monkeypatch.setattr(harness, "run_window", one_item_window)
    result, _lines = harness.run(CELL, SEED, 1e-3, 0, tree,
                                 time.perf_counter(), device="cpu")
    return result


def test_sound_run_is_correct(tree, memo, monkeypatch):
    result = run_with(tree, monkeypatch, memo[1])
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"prove_cycles_per_s", "peak_gib",
                                      "setup_s"}


def test_fault_state_unchanged(tree, memo, monkeypatch):
    last = []

    def stale(seg, **kw):
        out = memo[1](seg, **kw)
        if last:
            return last[0]  # the previous prove's seal, again
        last.append(out)
        return out

    result = run_with(tree, monkeypatch, stale)
    assert not result["correct"]
    assert result["checks"]["claims_wrong"]["value"] >= 1


def test_fault_answer_altered(tree, memo, monkeypatch):
    calls = []

    def altered(seg, **kw):
        out = memo[1](seg, **kw)
        calls.append(1)
        if len(calls) > 1:  # the window's item
            out[len(out) // 3] ^= 1
        return out

    result = run_with(tree, monkeypatch, altered)
    assert not result["correct"]
    assert result["checks"]["rejected"]["value"] == 1


def test_control_fewer_queries(tree, memo, monkeypatch):
    undo = control.plant("segment")
    try:
        result = run_with(tree, monkeypatch, memo[1])
    finally:
        undo()
    assert not result["correct"]
    assert result["checks"]["rejected"]["value"] == 2  # warm-up and item
