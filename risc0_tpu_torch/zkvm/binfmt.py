# The port's own copy of risc0_tpu/zkvm/binfmt.py.
"""ProgramBinary container (reference risc0/binfmt/src/elf.rs:133-420).

Layout: b"R0BF" | format_version u32 | header_len u32 | header |
user_len u32 | user_elf | kernel_elf.  The header is a postcard-encoded
kv list carrying AbiVersion(V1Compat, 1.0.0).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"R0BF"
BINARY_FORMAT_VERSION = 1

# postcard encoding of ProgramBinaryHeaderValueOnDisk::AbiVersion(V1Compat,
# semver 1.0.0): variant 0, kind variant 0, varints 1/0/0, two empty strings
_DEFAULT_HEADER_KV = bytes([0, 0, 1, 0, 0, 0, 0])


@dataclass
class ProgramBinary:
    user_elf: bytes
    kernel_elf: bytes

    def encode(self) -> bytes:
        header = struct.pack("<I", 1)
        header += struct.pack("<I", len(_DEFAULT_HEADER_KV)) + _DEFAULT_HEADER_KV
        out = MAGIC + struct.pack("<I", BINARY_FORMAT_VERSION)
        out += struct.pack("<I", len(header)) + header
        out += struct.pack("<I", len(self.user_elf)) + self.user_elf
        out += self.kernel_elf
        return out

    @staticmethod
    def decode(blob: bytes) -> "ProgramBinary":
        if blob[:4] != MAGIC:
            raise ValueError("Malformed ProgramBinary (bad magic)")
        (version,) = struct.unpack_from("<I", blob, 4)
        if version != BINARY_FORMAT_VERSION:
            raise ValueError("ProgramBinary version mismatch")
        (header_len,) = struct.unpack_from("<I", blob, 8)
        off = 12 + header_len
        (user_len,) = struct.unpack_from("<I", blob, off)
        off += 4
        user_elf = blob[off : off + user_len]
        kernel_elf = blob[off + user_len :]
        if not user_elf or not kernel_elf:
            raise ValueError("Malformed ProgramBinary (empty elf)")
        return ProgramBinary(user_elf, kernel_elf)
