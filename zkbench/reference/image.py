"""A guest's image ID, built plainly from its ELF files: the user ELF and
the kernel ELF are loaded into one word map, cut into pages of 1 KiB, and
the pages hashed into a Merkle tree of 2^22 leaves under Poseidon2, whose
root the tagged SystemState{pc 0, root} digests (risc0 binfmt/src/elf.rs
and image.rs).

- A page's digest absorbs its 256 words as 512 16-bit halves, low half
  first, 16 values a permutation; an absent page is the zero page.
- A node's digest hashes its right child's digest, then its left's.
- The user ELF fills addresses below 0xC0000000 and overrides the kernel's
  words; the word at USER_START holds the user entry, SUSPEND_PC the
  kernel entry and SUSPEND_MODE 1.
"""

import struct

from .claims import system_state
from .poseidon2 import hash_elems, hash_pair

PAGE_WORDS = 256
DEPTH = 22
USER_START = 0x0001_0000
USER_END = 0xC000_0000
SUSPEND_PC = 0xFFFF_0210
SUSPEND_MODE = 0xFFFF_0214


def load_elf(data: bytes, max_mem: int):
    """(entry, {address: word}) of a 32-bit RISC-V executable's PT_LOAD
    segments, zero-filled past each segment's file size."""
    if data[:4] != b"\x7fELF" or data[4] != 1:
        raise ValueError("not a 32-bit ELF")
    machine, = struct.unpack_from("<H", data, 18)
    if machine != 243:
        raise ValueError("not RISC-V")
    entry, phoff = struct.unpack_from("<II", data, 24)
    phentsize, phnum = struct.unpack_from("<HH", data, 42)
    if entry >= max_mem or entry % 4:
        raise ValueError("invalid entry point")
    words = {}
    for i in range(phnum):
        p_type, offset, vaddr, _paddr, filesz, memsz = struct.unpack_from(
            "<6I", data, phoff + i * phentsize)
        if p_type != 1:
            continue
        if vaddr % 4 or vaddr + memsz > max_mem:
            raise ValueError("segment out of range")
        for off in range(0, memsz, 4):
            chunk = data[offset + off:offset + min(off + 4, filesz)] \
                if off < filesz else b""
            words[vaddr + off] = int.from_bytes(chunk.ljust(4, b"\0"),
                                                "little")
    return entry, words


def _halves(words):
    out = []
    for w in words:
        out += [w & 0xFFFF, w >> 16]
    return out


def image_root(words) -> tuple:
    """The Merkle root of a {address: word} memory image."""
    pages = {}
    for addr, w in words.items():
        page = pages.setdefault(addr // 4 // PAGE_WORDS, [0] * PAGE_WORDS)
        page[addr // 4 % PAGE_WORDS] = w
    zero = [hash_elems([0] * 2 * PAGE_WORDS)]
    for _ in range(DEPTH):
        zero.append(hash_pair(zero[-1], zero[-1]))
    level = {idx: hash_elems(_halves(p)) for idx, p in pages.items()}
    for depth in range(DEPTH):
        up = {}
        for idx in {i // 2 for i in level}:
            left = level.get(2 * idx, zero[depth])
            right = level.get(2 * idx + 1, zero[depth])
            up[idx] = hash_pair(right, left)
        level = up
    return level.get(0, zero[DEPTH])


def image_id(user_elf: bytes, kernel_elf: bytes) -> bytes:
    """SystemState{pc 0, root}'s digest of the user and kernel ELFs."""
    kentry, words = load_elf(kernel_elf, 1 << 32)
    uentry, user = load_elf(user_elf, USER_END)
    user[USER_START] = uentry
    words.update(user)
    words[SUSPEND_PC] = kentry
    words[SUSPEND_MODE] = 1
    root = image_root(words)
    return system_state(0, struct.pack("<8I", *root))


def image_id_of_files(user_path: str, kernel_path: str) -> bytes:
    with open(user_path, "rb") as f:
        user = f.read()
    with open(kernel_path, "rb") as f:
        kernel = f.read()
    return image_id(user, kernel)
