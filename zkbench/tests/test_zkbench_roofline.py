"""The roofline table reproduces chip_smoke.py's bounds; the kernel and
idle readings of a traced prove on a fake trace."""

import json
import os

import pytest

from zkbench import roofline
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_bounds_of_chip_smoke():
    ms, by = roofline.hash_rows_bound(211, 1 << 22)
    assert round(ms, 5) == 14.28071 and by == "operations"
    ms, by = roofline.ntt_bound(211, 22, 20, False)  # expand((211, 2^20), 2)
    assert round(ms, 5) == 2.11343 and by == "bytes"


def test_prove_table_of_loop_po2_20():
    with open(os.path.join(ROOT, "zkbench", "configs",
                           "loop_po2_20.json")) as f:
        cfg = json.load(f)
    calls = roofline.prove_calls(cfg["segment_po2"], cfg["widths"],
                                 **cfg["stark"])
    table = {(k, s): ms for k, s, ms in calls}
    assert round(table[("hash_rows", (211, 1 << 22))], 5) == 14.28071
    assert round(table[("evaluate_ntt", (211, 1 << 20))], 5) == 2.11343
    # four trees of 2^22 leaves (code, data, accum, check) and three FRI
    # rounds (2^18, 2^14, 2^10 rows of 64 columns), then the final digest
    assert [s for k, s, _ in calls if k == "fold"] == [1 << 22] * 4 + [
        1 << 18, 1 << 14, 1 << 10]
    assert [s for k, s, _ in calls if k == "hash_rows"][-4:] == [
        (64, 1 << 18), (64, 1 << 14), (64, 1 << 10), (1024, 1)]
    assert roofline.prove_bound_s(20, cfg["widths"], **cfg["stark"]) == \
        pytest.approx(sum(ms for _k, _s, ms in calls) / 1e3)


def traced(records, launches, items_s=(20.0,)):
    """Readings of a traced segment prove: `records` device operations of
    each listed name, each 1 ms, and the program's launch counters."""
    from zkbench import devtrace

    ops, t = [], 0
    for name, n in records.items():
        for _ in range(n):
            ops.append((f"void (anonymous namespace)::{name}(unsigned int "
                        "const*, unsigned int*)", t, t + 10**6))
            t += 2 * 10**6
    with open(os.path.join(ROOT, "zkbench", "configs",
                           "loop_po2_20.json")) as f:
        cfg = json.load(f)
    return {"items": [{"s": s} for s in items_s],
            "trace": devtrace.DeviceTrace(ops, 0.0, 0, 30.0),
            "config": cfg, "launches": launches}


SOUND = ({"hash_rows_kernel": 8, "merkle_fold_kernel": 22,
          "contiguous_kernel<true>": 13, "contiguous_kernel<false>": 10,
          "strided_kernel<true, 5>": 13, "strided_kernel<false, 5>": 10},
         {"risc0_tpu_torch.hal.cuda.poseidon2:hash_rows": 8,
          "risc0_tpu_torch.hal.cuda.poseidon2:hash_pairs": 22,
          "risc0_tpu_torch.hal.cuda.ntt:evaluate_ntt": 13,
          "risc0_tpu_torch.hal.cuda.ntt:interpolate_ntt": 10})


def test_roofline_read_when_every_launch_is_traced():
    from zkbench import readings

    r = traced(*SOUND)
    assert readings.launches_kept(r)
    got = readings.segment_roofline_pct(r)
    want = 100 * roofline.prove_bound_s(20, r["config"]["widths"],
                                        **r["config"]["stark"]) / 0.076
    assert got == pytest.approx(want)


@pytest.mark.parametrize("kernel, n", [("hash_rows_kernel", 7),
                                       ("merkle_fold_kernel", 21),
                                       ("contiguous_kernel<true>", 0)])
def test_roofline_refused_when_records_are_missing(kernel, n):
    """A trace that dropped a record of a timed kernel reads no roofline."""
    from zkbench import readings

    records = dict(SOUND[0])
    records[kernel] = n
    if kernel == "contiguous_kernel<true>":
        # 22 NTT records for 23 counted calls
        records.update({"contiguous_kernel<false>": 0,
                        "strided_kernel<true, 5>": 12})
    r = traced(records, SOUND[1])
    assert not readings.launches_kept(r)
    assert readings.segment_roofline_pct(r) is None


def test_idle_share_over_the_untraced_items():
    """Busy seconds of the traced item over the window items' mean wall
    time, not over the longer profiled item."""
    from zkbench import readings

    r = traced(*SOUND, items_s=(19.0, 21.0))
    busy = 76 * 1e-3
    assert r["trace"].busy_s() == pytest.approx(busy)
    assert readings.idle_pct(r) == pytest.approx(100 * (1 - busy / 20.0))
