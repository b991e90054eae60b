"""One segment's commits spread over several devices (counterpart of
``risc0_tpu/parallel/sharded.py``).

`mesh_context(devices)` installs a list of torch devices in the HAL: while
it is installed, the commit and check pipelines (``hal/torch_hal.py``)
split the trace columns over the devices for the per-column iNTT, zk shift
and LDE (no exchange: each column's NTT is independent), reshard once to
contiguous row blocks for the Poseidon2 leaf hashes and subtrees, and fold
the top layers on the first device; the constraint evaluation
(``circuit/ir_range.make_eval_check``) splits its domain chunks over the
devices.  Every op is deterministic, so a prove under the mesh emits the
one-device seal byte for byte.

The design is the JAX package's: one controller process over a list of
devices, as its one-process ``Mesh``, not one process a device.  The list
may name a device more than once, so one card (or the CPU) checks the
sharded path against the one-device path.

It is kept for parity with the JAX package, and the one-device path stays
the reference: on four H100s it proves no faster than one card and relieves
no memory, since every group is gathered back to the first device (PERF.md,
ROADMAP.md queue 1).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..convert import card
from ..hal import torch_hal as hal
from ..hash.suite import POSEIDON2


def _devices(devices) -> list:
    if devices is None:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(count)] if count > 1 \
            else ["cuda"]
    devs = [card(d) for d in devices]
    if not devs:
        raise ValueError("mesh_context needs at least one device")
    return devs


@contextmanager
def mesh_context(devices=None):
    """Install `devices` (torch devices or their names; default: every
    card) for the HAL pipelines; restores the previous state on exit, an
    exception's included.

    One mesh per process, as in the JAX package: the mesh is process-global
    state that every thread's commits read, so install it before proving
    starts and do not switch it while another thread proves."""
    devs = _devices(devices)
    prev = hal.set_mesh(devs)
    try:
        yield hal.mesh()
    finally:
        hal.set_mesh(prev)


def commit_sharded(witness, devices=None, suite=POSEIDON2):
    """One group commit over `devices` (default: every card); returns
    (coeffs_nat, evaluated, layers) on the first device, exactly as
    hal.commit_pipeline."""
    with mesh_context(devices) as devs:
        return hal.commit_pipeline(witness, device=devs[0], suite=suite)
