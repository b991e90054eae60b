"""Kernels of the keccak prover (hal/cuda, csrc/*.cu): the least time one
H100 could take for the hashing and NTT work of the traced item's keccak
proves (zkbench/roofline.py at each batch's po2, over the keccak circuit's
committed groups) as a share of the device time of the kernels listed in
zkbench/kernels/ inside its `prove_keccak` spans; no reading where the
trace holds fewer or more of their launches than the program's launch
counters allow."""

from zkbench import roofline
from zkbench.readings import kernel_names, launches_kept
from zkbench.spans import device_bounds, items


def read(readings):
    trace, cfg = readings["trace"], readings["config"]
    got = items(readings)
    if trace is None or got is None or not launches_kept(readings):
        return None
    hit = got[1].under(got[1].root, "prove_keccak")
    if not hit:
        return None
    names = kernel_names()
    kernel_ns = 0
    for span in hit:
        lo, hi = device_bounds(trace, span)
        kernel_ns += sum(e - s for n, s, e in trace.ops
                         if lo <= s < hi and any(k in n for k in names))
    if kernel_ns <= 0:
        return None
    bound = sum(roofline.prove_bound_s(
        int(span.attributes.get("po2", cfg["keccak_po2"])),
        cfg["keccak_widths"], **cfg["stark"]) for span in hit)
    return 100.0 * bound / (kernel_ns / 1e9)
