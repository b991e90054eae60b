"""Kernels (hal/cuda, csrc/*.cu): the least time one H100 could take for
the hashing and NTT work of the traced segment prove (zkbench/roofline.py)
as a share of the device time of the kernels listed in zkbench/kernels/;
no reading where the trace holds fewer or more of their launches than the
program's launch counters allow."""

from zkbench.readings import segment_roofline_pct


def read(readings):
    return segment_roofline_pct(readings)
