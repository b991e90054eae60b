"""Typed access to the rv32im global layout (counterpart of the
``rv32im_global_layout`` half of ``risc0_tpu/circuit/layout.py``;
reference: the zirgen-generated ``LAYOUT_GLOBAL`` and risc0_zkp's
``layout::Reg`` readers).

The layout is the extracted JSON tree of column offsets under
``assets.RV32IM_DATA``.  ``LayoutView`` wraps a tree with attribute and
index access and typed readers over a row of values:

    glob = rv32im_global_layout()
    glob.state_in.read_digest(row)     # 8-word digest from lo/hi shorts
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

from ..assets import RV32IM_DATA


class LayoutView:
    """Attribute/index access over an extracted layout tree.  Leaves are
    integer column offsets exposed as `.offset`."""

    def __init__(self, node, name: str = "layout"):
        self._node = node
        self._name = name

    @property
    def offset(self) -> int:
        node = self._node
        if isinstance(node, dict) and "_super" in node:
            return LayoutView(node["_super"], self._name).offset
        if isinstance(node, int):
            return node
        raise TypeError(f"{self._name} is not a register leaf")

    def __getattr__(self, key: str):
        node = self._node
        if isinstance(node, dict):
            for k in (key, _camel(key)):
                if k in node:
                    return LayoutView(node[k], f"{self._name}.{key}")
        raise AttributeError(f"{self._name} has no field {key!r}")

    def __getitem__(self, idx: int):
        if isinstance(self._node, list):
            return LayoutView(self._node[idx], f"{self._name}[{idx}]")
        raise TypeError(f"{self._name} is not an array")

    def __len__(self) -> int:
        if isinstance(self._node, list):
            return len(self._node)
        raise TypeError(f"{self._name} is not an array")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def keys(self):
        """Field names of a struct node (none for an array or a leaf).  A
        method of the class, so `__getattr__` never reads it as a field."""
        return list(self._node) if isinstance(self._node, dict) else []

    def __repr__(self):
        kind = ("reg" if isinstance(self._node, int)
                else type(self._node).__name__)
        return f"LayoutView({self._name}: {kind})"

    def read(self, row) -> int:
        """Value at this register's column."""
        return int(np.asarray(row)[self.offset])

    def read_u32_pair(self, row) -> int:
        """low/high 16-bit halves -> u32; halves outside 16 bits raise, as
        in the reference's decode paths."""
        r = np.asarray(row)
        low, high = int(r[self.low.offset]), int(r[self.high.offset])
        if low >= 1 << 16 or high >= 1 << 16:
            raise ValueError(f"{self._name}: 16-bit half out of range")
        return low | (high << 16)

    def read_digest(self, row) -> np.ndarray:
        """8 lo/hi word pairs -> (8,) uint32 digest (DigestReg)."""
        node = self._node
        vals = self.values if isinstance(node, dict) and "values" in node \
            else self
        return np.array([vals[i].read_u32_pair(row) for i in range(8)],
                        np.uint32)

    def dump(self, row=None, depth: int = 0) -> str:
        """Readable rendering of the subtree, with values read from `row`
        when given (reference layout.rs Debug visitor)."""
        pad = "  " * depth
        node = self._node
        if isinstance(node, int):
            val = "" if row is None else f" = {int(np.asarray(row)[node])}"
            return f"{pad}{self._name.rsplit('.', 1)[-1]}: [{node}]{val}\n"
        out = f"{pad}{self._name.rsplit('.', 1)[-1]}:\n"
        children = (self if isinstance(node, list)
                    else (getattr(self, k) for k in self.keys()))
        for child in children:
            out += child.dump(row, depth + 1)
        return out


def _camel(key: str) -> str:
    parts = key.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


@lru_cache(maxsize=None)
def rv32im_global_layout() -> LayoutView:
    """LAYOUT_GLOBAL equivalent (90 global columns)."""
    with open(os.path.join(RV32IM_DATA, "global_layout.json")) as f:
        return LayoutView(json.load(f), "LAYOUT_GLOBAL")
