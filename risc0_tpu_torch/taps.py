# The port's own copy of risc0_tpu/taps.py.
"""Tap set: static description of circuit register groups and openings.

Mirrors the reference TapSet (risc0/zkp/src/taps.rs:57-140): registers grouped
into accum/code/data, each register opened at a set of "backs" (rows behind
the current row); registers with identical back-sets share a "combo" so the
DEEP phase can share denominators.

Group IDs follow the reference convention (risc0/zkp/src/adapter.rs:27-29):
ACCUM=0, CODE=1, DATA=2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Sequence

REGISTER_GROUP_ACCUM = 0
REGISTER_GROUP_CODE = 1
REGISTER_GROUP_DATA = 2


@dataclass(frozen=True)
class Reg:
    group: int
    offset: int
    combo_id: int
    backs: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.backs)


@dataclass
class TapSet:
    group_names: tuple[str, ...]
    regs: list[Reg]              # sorted by (group, offset)
    combos: list[tuple[int, ...]]  # combo_id -> back set (sorted)

    @staticmethod
    def from_backs(group_names: Sequence[str], group_backs: Sequence[Sequence[Sequence[int]]]) -> "TapSet":
        """Build from per-group per-register back lists.

        group_backs[g][offset] = iterable of backs for that register.
        Combos are deduplicated in order of first appearance, matching the
        zirgen generator's layout.
        """
        combos: list[tuple[int, ...]] = []
        combo_ids: dict[tuple[int, ...], int] = {}
        regs: list[Reg] = []
        for g, backs_list in enumerate(group_backs):
            for offset, backs in enumerate(backs_list):
                backs = tuple(sorted(set(int(b) for b in backs)))
                assert backs, f"register {g}/{offset} has no taps"
                if backs not in combo_ids:
                    combo_ids[backs] = len(combos)
                    combos.append(backs)
                regs.append(Reg(g, offset, combo_ids[backs], backs))
        return TapSet(tuple(group_names), regs, combos)

    @property
    def num_groups(self) -> int:
        return len(self.group_names)

    def group_regs(self, group_id: int) -> list[Reg]:
        return [r for r in self.regs if r.group == group_id]

    def group_size(self, group_id: int) -> int:
        rs = self.group_regs(group_id)
        return (max(r.offset for r in rs) + 1) if rs else 0

    @cached_property
    def reg_count(self) -> int:
        return len(self.regs)

    @cached_property
    def tap_size(self) -> int:
        """Total number of taps (sum of per-register back counts)."""
        return sum(r.size for r in self.regs)

    @property
    def combos_size(self) -> int:
        return len(self.combos)

    @cached_property
    def combo_begin(self) -> list[int]:
        out = [0]
        for c in self.combos:
            out.append(out[-1] + len(c))
        return out

    @cached_property
    def tot_combo_backs(self) -> int:
        return self.combo_begin[-1]

    def group_taps(self, group_id: int) -> list[tuple[int, int]]:
        """(offset, back) pairs in tap order for one group."""
        out = []
        for r in self.group_regs(group_id):
            for b in r.backs:
                out.append((r.offset, b))
        return out
