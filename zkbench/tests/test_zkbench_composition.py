"""The keccak composition cell on the CPU: its judge on an item recorded on
the card (zkbench/tests/record_composition.py made it; an item takes
minutes of card time, so it is replayed), and the readers of its
per-layer metrics on spans and a device trace made here.

The recorded item reads correct.  A flipped word of its succinct seal, a
wrong journal, a final claim that keeps the root assumption, a program
other than `resolve` and a batch claim other than the reference's each
read not correct, each under its own count."""

import os

import numpy as np
import pytest

from zkbench import devtrace, harness, manifest, roofline, spans
from zkbench.reference import claims

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "zkbench", "tests", "data",
                    "keccak_composition.npz")
CELL = "keccak.composition"


def recorded():
    z = np.load(DATA)
    seed = int(z["seed"])
    cell = manifest.Cell(ROOT, CELL)
    kind = cell.traffic_module()
    segs, j = [], 0
    while f"seg{j}" in z.files:
        segs.append((int(z[f"seg{j}_po2"]), z[f"seg{j}"]))
        j += 1
    batches, j = [], 0
    while f"keccak{j}_n" in z.files:
        batches.append({"n": int(z[f"keccak{j}_n"]),
                        "po2": int(z[f"keccak{j}_po2"]),
                        "claim": z[f"keccak{j}_claim"].tobytes(),
                        "out": z[f"keccak{j}_out"].copy()})
        j += 1
    rec = {"k": 0, "kind": "succinct", "self_checks": 1, "segments": segs,
           "keccak": batches,
           "inputs": cell.guest_module().inputs(cell.config,
                                                kind.stream(seed, 1, 0)),
           "journal": z["journal"].tobytes(),
           "exit": ("Halted", int(z["exit"][0])),
           "seal": z["seal"].copy()}
    drv = kind.Traffic(harness.Context(cell, seed, "cpu"))
    return drv, rec, z["lift_seal"].copy()


@pytest.fixture(scope="module")
def sound():
    return recorded()


def judge(drv, rec):
    drv.warm = rec
    return drv.judge([])


def faults(checks):
    return {k: v for k, (v, _lim) in checks.items() if v}


def relabel(monkeypatch, a, b):
    """The allowed set with the IDs of programs a and b swapped."""
    ids, root = claims.allowed_set()
    ids = dict(ids, **{a: ids[b], b: ids[a]})
    monkeypatch.setattr(claims, "allowed_set", lambda: (ids, root))


def test_recorded_item_is_correct(sound):
    drv, rec, _lift = sound
    assert [b["n"] for b in rec["keccak"]] == drv.config["keccak_batches"]
    checks = judge(drv, rec)
    assert set(checks) == {"rejected", "claims_wrong", "journals_wrong",
                           "keccak_claims_wrong", "unchecked"}
    assert faults(checks) == {}


def test_flipped_seal_word_is_rejected(sound):
    drv, rec, _lift = sound
    seal = rec["seal"].copy()
    seal[len(seal) // 2] ^= 1
    assert faults(judge(drv, dict(rec, seal=seal))) == {"rejected": 1}


def test_wrong_journal(sound):
    drv, rec, _lift = sound
    journal = bytes([rec["journal"][0] ^ 1]) + rec["journal"][1:]
    assert faults(judge(drv, dict(rec, journal=journal))) == \
        {"journals_wrong": 1}


def test_claim_that_keeps_its_assumption(sound, monkeypatch):
    """The segment's lift in place of the resolve, with its program named
    `resolve`: the seal verifies, its claim still holds the assumption."""
    drv, rec, lift = sound
    relabel(monkeypatch, "resolve", f"lift_rv32im_{rec['segments'][0][0]}")
    assert faults(judge(drv, dict(rec, seal=lift))) == {"claims_wrong": 1}


@pytest.mark.parametrize("program", ["lift", "join"])
def test_code_root_other_than_resolve(sound, monkeypatch, program):
    drv, rec, lift = sound
    if program == "lift":
        bad = dict(rec, seal=lift)
    else:  # the resolve seal, its program taken for join
        relabel(monkeypatch, "resolve", "join")
        bad = rec
    assert faults(judge(drv, bad)) == {"claims_wrong": 1}


@pytest.mark.parametrize("fault", ["claim", "lifted", "size", "missing"])
def test_batch_claim_other_than_the_references(sound, fault):
    drv, rec, _lift = sound
    batches = [dict(b) for b in rec["keccak"]]
    if fault == "claim":
        batches[1]["claim"] = bytes(32)
    elif fault == "lifted":
        batches[0]["out"] = rec["keccak"][1]["out"]
    elif fault == "size":
        batches[0]["n"] -= 1
    else:
        batches = batches[:1]
    assert faults(judge(drv, dict(rec, keccak=batches))) == \
        {"keccak_claims_wrong": 1}


def test_item_that_failed_is_rejected(sound):
    drv, rec, _lift = sound
    drv.warm = rec
    checks = drv.judge([{"k": 1, "error": "RuntimeError: x"}])
    assert faults(checks) == {"rejected": 1}


# -- the readers ----------------------------------------------------------------

MS = 1_000_000


class Span:
    def __init__(self, name, start, end, parent=None, **attrs):
        self.name, self.attributes = name, attrs
        self.start_ns, self.end_ns = start * MS, end * MS
        self.trace_id = parent.trace_id if parent else f"t{start}"
        self.parent_id = parent.span_id if parent else None
        self.span_id = f"{name}{start}"


def item(t):
    """One item's spans from t ms: the execution (5 ms), the segment (5),
    a batch prove of 100 ms (10 of them witgen), its lift of 50 ms (20 of
    them the seal's check, 10 its preflight), a union of 30 ms (12 its
    preflight), the segment's lift of 10 ms (4), a resolve of 20 ms (8)
    and the self-check of 30 ms (5 of them the validity check, 20 FRI),
    under a root of 400 ms."""
    root = Span("prove", t, t + 400)
    kp = Span("prove_keccak", t + 10, t + 110, root, po2=17,
              permutations=655)
    lk = Span("lift_keccak", t + 110, t + 160, root,
              program="keccak_lift_17")
    un = Span("union", t + 200, t + 230, root)
    lift = Span("lift", t + 240, t + 250, root, po2=18,
                program="lift_rv32im_18")
    res = Span("resolve", t + 250, t + 270, root)
    check = Span("self_check", t + 300, t + 330, root)
    return [root, Span("execute", t, t + 5, root),
            Span("prove_segment", t + 5, t + 10, root, po2=18), kp,
            Span("keccak_preflight", t + 10, t + 14, kp),
            Span("keccak_witgen", t + 14, t + 20, kp), lk,
            Span("verify_keccak", t + 110, t + 130, lk),
            Span("rec_preflight", t + 132, t + 142, lk), un,
            Span("rec_preflight", t + 200, t + 212, un), lift,
            Span("rec_preflight", t + 240, t + 244, lift), res,
            Span("rec_preflight", t + 250, t + 258, res), check,
            Span("verify_validity", t + 300, t + 305, check),
            Span("verify_fri", t + 305, t + 325, check)], kp


# the harness's timers of the window's item
CALLS = {"executor": [{"s": 0.005, "scopes": {}}],
         "prove_segment": [{"s": 0.006, "scopes": {}}],
         "lift": [{"s": 0.011, "scopes": {"rec_preflight": (1, 0.004)}}],
         "self_check": [{"s": 0.031, "scopes": {}}]}


@pytest.fixture
def readings(monkeypatch):
    window, _ = item(0)
    traced, kp = item(1000)
    monkeypatch.setattr(spans, "recorded", lambda: window + traced)
    # the traced prove_keccak: 40 kernels of 1 ms, 20 of them listed
    # hashing kernels; a copy; a kernel outside it
    ops = [(f"{'::hash_rows_kernel' if i % 2 else 'eval'}(int)",
            (1011 + 2 * i) * MS, (1012 + 2 * i) * MS) for i in range(40)]
    ops += [("Memcpy HtoD", 1012 * MS, 1013 * MS),
            ("other", 1200 * MS, 1201 * MS)]
    trace = devtrace.DeviceTrace(ops, 0.0, 0, 2.0)
    cell = manifest.Cell(ROOT, CELL)
    return {"items": [{"s": 0.4, "calls": CALLS}], "trace": trace, "config": cell.config,
            "launches": {}}


def test_every_metric_of_the_cell_has_its_reader(readings, monkeypatch):
    from zkbench import readings as reading

    monkeypatch.setattr(reading, "launch_groups", lambda: [])
    cell = manifest.Cell(ROOT, CELL)
    got = {m["name"]: cell.metric_reader(m["name"]).read(readings)
           for m in cell.per_layer()}
    bound = roofline.prove_bound_s(17, [1, 1096, 1], check_size=16,
                                   inv_rate=4, fold=16, min_degree=256)
    want = {"keccak_witgen_s": 0.010, "keccak_prove_s": 0.090,
            "keccak_verify_s": 0.020,
            "keccak_rec_preflight_s": 0.010 + 0.012 + 0.008,
            "keccak_rec_prove_s": (0.050 - 0.020 - 0.010) + (0.030 - 0.012)
            + (0.020 - 0.008),
            "keccak_prove_launches": 40,
            "device_idle_pct.receipt": 100.0 * (1 - 0.042 / 0.4),
            "keccak_roofline_pct": 100.0 * bound / 0.020,
            "executor_s": 0.005, "segment_prove_s": 0.006,
            "rec_preflight_s": 0.004, "rec_prove_s": 0.011 - 0.004,
            "self_check_s": 0.031, "execute_span_s": 0.005,
            "prove_segment_span_s": 0.005, "rec_prove_span_s": 0.006,
            "self_check_span_s": 0.030, "self_check_validity_s": 0.005,
            "self_check_fri_s": 0.020,
            "receipt_self_s": 0.400 - (0.005 + 0.005 + 0.100 + 0.050
                                       + 0.030 + 0.010 + 0.020 + 0.030)}
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name] == pytest.approx(v), name


def test_readers_read_nothing_without_spans(readings, monkeypatch):
    """Every reader of the program's spans reads nothing where the
    program records none (the parent's keccak spans, for one)."""
    monkeypatch.setattr(spans, "recorded", lambda: [])
    cell = manifest.Cell(ROOT, CELL)
    for m in cell.per_layer():
        reader = cell.metric_reader(m["name"])
        if (getattr(reader, "mean_item_s", None) is spans.mean_item_s
                or m["name"].startswith("keccak_")):
            assert reader.read(readings) is None, m["name"]
