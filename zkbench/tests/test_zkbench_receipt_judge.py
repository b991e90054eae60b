"""The receipt cell's judge on items recorded on the card (a receipt
takes minutes of CPU, so they are replayed; zkbench/tests/record_receipts.py
made them): sound items read correct, each fault a receipt cell can have
reads not correct, and so do items made with the control planted.  Every
recorded item returned from `prove` after one self-check of its receipt
(with the control planted, the self-check that the control empties), so
each replays with `self_checks` 1."""

import os

import numpy as np
import pytest

from zkbench import harness, manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "zkbench", "tests", "data")
CELL = "ecdsa.succinct"


def records(path):
    z = np.load(path)
    seed = int(z["seed"])
    cell = manifest.Cell(ROOT, CELL)
    kind = cell.traffic_module()
    guest = cell.guest_module()
    ks = sorted({int(k.split("_")[0][1:]) for k in z.files if k[0] == "k"})
    recs = []
    for k in ks:
        segs = []
        j = 0
        while f"k{k}_seg{j}" in z.files:
            segs.append((int(z[f"k{k}_seg{j}_po2"]), z[f"k{k}_seg{j}"]))
            j += 1
        recs.append({"k": k, "kind": "succinct", "self_checks": 1,
                     "segments": segs,
                     "inputs": guest.inputs(cell.config,
                                            kind.stream(seed, 1, k)),
                     "journal": z[f"k{k}_journal"].tobytes(),
                     "exit": ("Halted", int(z[f"k{k}_exit"][0])),
                     "seal": z[f"k{k}_seal"].copy()})
    ctx = harness.Context(cell, seed, "cpu")
    drv = kind.Traffic(ctx)
    return drv, recs


def judge(drv, recs):
    drv.warm = recs[0]
    checks = drv.judge(recs[1:])
    return all(v <= lim for v, lim in checks.values()), checks


@pytest.fixture(scope="module")
def sound():
    return records(os.path.join(DATA, "ecdsa_succinct.npz"))


def test_sound_items_are_correct(sound):
    ok, checks = judge(*sound)
    assert ok, checks


def test_fault_state_unchanged(sound):
    drv, recs = sound
    stale = dict(recs[1], **{k: recs[0][k] for k in
                             ("segments", "journal", "exit", "seal")})
    ok, checks = judge(drv, [recs[0], stale])
    assert not ok
    assert checks["journals_wrong"][0] == 1 and checks["claims_wrong"][0] >= 1


@pytest.mark.parametrize("part", ["seal", "segment", "journal"])
def test_fault_answer_altered(sound, part):
    drv, recs = sound
    bad = dict(recs[1])
    if part == "seal":
        bad["seal"] = recs[1]["seal"].copy()
        bad["seal"][len(bad["seal"]) // 2] ^= 1
    elif part == "segment":
        po2, seal = recs[1]["segments"][0]
        seal = seal.copy()
        seal[len(seal) // 3] ^= 1
        bad["segments"] = [(po2, seal)]
    else:
        bad["journal"] = bytes([recs[1]["journal"][0] ^ 1]) + \
            recs[1]["journal"][1:]
    ok, checks = judge(drv, [recs[0], bad])
    assert not ok
    want = {"seal": "rejected", "segment": "rejected",
            "journal": "journals_wrong"}[part]
    assert checks[want][0] == 1


def test_fault_receipt_not_compressed(sound):
    """A prove that returns the composite receipt, skipping the lift."""
    drv, recs = sound
    bad = dict(recs[1], kind="composite")
    del bad["seal"]
    ok, checks = judge(drv, [recs[0], bad])
    assert not ok
    assert checks["claims_wrong"][0] == 1


@pytest.mark.parametrize("count", [0, 2])
def test_fault_self_check_not_once(sound, count):
    drv, recs = sound
    ok, checks = judge(drv, [recs[0], dict(recs[1], self_checks=count)])
    assert not ok
    assert checks["unchecked"][0] == 1


def test_control_items_are_not_correct():
    drv, recs = records(os.path.join(DATA, "ecdsa_succinct_control.npz"))
    ok, checks = judge(drv, recs)
    assert not ok
    assert checks["rejected"][0] == len(recs)  # every succinct seal
