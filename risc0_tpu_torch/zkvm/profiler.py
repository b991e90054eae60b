# The port's own copy of risc0_tpu/zkvm/profiler.py.
"""Guest cycle profiler -> pprof protobuf.

The native executor (csrc/r0vm.cpp) records a flat pc -> cycles map while
stepping (reference risc0/zkvm/src/host/server/exec/profiler.rs:160-320,
which samples per-instruction cycle counts and emits a
perftools.profiles.Profile).  This module reads the map back through the C
API, symbolizes pcs against the guest ELF's symbol table, and hand-encodes
the pprof protobuf (no protobuf runtime dependency).
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field


from .proto import bytes_field as _bytes_field
from .proto import packed as _packed
from .proto import uint as _uint


# ---------------------------------------------------------------------------
# ELF symbol table (RISC-V rv32 guest): pc -> enclosing function name

def elf_functions(elf: bytes) -> list[tuple[int, int, str]]:
    """[(addr, size, name)] for STT_FUNC symbols, sorted by addr."""
    if elf[:4] != b"\x7fELF" or elf[4] != 1:  # 32-bit little-endian
        return []
    e_shoff, = struct.unpack_from("<I", elf, 32)
    e_shentsize, e_shnum = struct.unpack_from("<HH", elf, 46)
    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (sh_name, sh_type, _flags, _addr, sh_offset, sh_size, sh_link,
         _info, _align, sh_entsize) = struct.unpack_from("<10I", elf, off)
        sections.append((sh_type, sh_offset, sh_size, sh_link, sh_entsize))
    funcs = []
    for sh_type, sh_offset, sh_size, sh_link, sh_entsize in sections:
        if sh_type not in (2, 11):  # SHT_SYMTAB, SHT_DYNSYM
            continue
        str_off, str_size = sections[sh_link][1], sections[sh_link][2]
        strtab = elf[str_off : str_off + str_size]
        count = sh_size // (sh_entsize or 16)
        for i in range(count):
            off = sh_offset + i * (sh_entsize or 16)
            st_name, st_value, st_size, st_info = struct.unpack_from(
                "<IIIB", elf, off)
            if st_info & 0xF != 2:  # STT_FUNC
                continue
            end = strtab.find(b"\0", st_name)
            name = strtab[st_name:end].decode("utf-8", "replace")
            if name:
                funcs.append((st_value, st_size, name))
    funcs.sort()
    return funcs


class Symbolizer:
    def __init__(self, elfs: list[bytes]):
        self.funcs = []
        for e in elfs:
            self.funcs.extend(elf_functions(e))
        self.funcs.sort()
        self.starts = [f[0] for f in self.funcs]

    def lookup(self, pc: int) -> str | None:
        i = bisect.bisect_right(self.starts, pc) - 1
        if i < 0:
            return None
        addr, size, name = self.funcs[i]
        if size and pc >= addr + size:
            return None
        return name


# ---------------------------------------------------------------------------

@dataclass
class Profiler:
    """Collects the flat pc->cycles profile from a profiled execution and
    encodes perftools.profiles.Profile bytes (readable by `pprof` / go tool
    pprof).  Mirrors reference profiler.rs output shape: one sample per pc
    with a single "cycles/count" value and one Location/Line each."""

    samples: dict = field(default_factory=dict)  # pc -> cycles
    elfs: list = field(default_factory=list)

    def add_samples(self, pcs, cycles) -> None:
        for pc, n in zip(pcs, cycles):
            self.samples[int(pc)] = self.samples.get(int(pc), 0) + int(n)

    def total_cycles(self) -> int:
        return sum(self.samples.values())

    def top_functions(self, k: int = 10) -> list[tuple[str, int]]:
        sym = Symbolizer(self.elfs)
        agg: dict[str, int] = {}
        for pc, n in self.samples.items():
            name = sym.lookup(pc) or f"0x{pc:08x}"
            agg[name] = agg.get(name, 0) + n
        return sorted(agg.items(), key=lambda kv: -kv[1])[:k]

    def encode_to_vec(self) -> bytes:
        """pprof protobuf (profile.proto): string_table, sample_type
        [cycles/count], one Function per symbol, one Location per pc."""
        strings: list[str] = [""]
        sidx: dict[str, int] = {"": 0}

        def intern(s: str) -> int:
            if s not in sidx:
                sidx[s] = len(strings)
                strings.append(s)
            return sidx[s]

        sym = Symbolizer(self.elfs)
        func_ids: dict[str, int] = {}
        functions = b""
        locations = b""
        samples_msg = b""
        for pc, n in sorted(self.samples.items()):
            name = sym.lookup(pc) or f"0x{pc:08x}"
            if name not in func_ids:
                fid = len(func_ids) + 1
                func_ids[name] = fid
                fn = _uint(1, fid) + _uint(2, intern(name)) + \
                    _uint(3, intern(name))
                functions += _bytes_field(5, fn)
            loc_id = pc + 1  # ids must be nonzero; use pc+1
            line = _uint(1, func_ids[name])
            loc = _uint(1, loc_id) + _uint(3, pc) + _bytes_field(4, line)
            locations += _bytes_field(4, loc)
            sample = _packed(1, [loc_id]) + _packed(2, [n])
            samples_msg += _bytes_field(2, sample)

        vt = _uint(1, intern("cycles")) + _uint(2, intern("count"))
        out = _bytes_field(1, vt) + samples_msg + locations + functions
        for s in strings:
            out += _bytes_field(6, s.encode())
        return out


def read_profile(lib, session_handle) -> tuple[list[int], list[int]]:
    """Drain the native session's pc->cycles map (csrc/api.cpp
    r0_session_profile_*)."""
    import ctypes as C

    n = lib.r0_session_profile_size(session_handle)
    pcs = (C.c_uint32 * n)()
    cyc = (C.c_uint64 * n)()
    if n:
        lib.r0_session_profile_read(session_handle, pcs, cyc)
    return list(pcs), list(cyc)
