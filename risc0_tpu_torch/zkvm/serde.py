# The port's own copy of risc0_tpu/zkvm/serde.py.
"""zkVM word-oriented serde for guest IO (reference: risc0/zkvm/src/serde/).

The guest ABI streams 32-bit words: integers up to u32 are one word, u64/u128
are padded little-endian bytes, strings/bytes are a u32 length followed by
zero-padded words, sequences are a u32 length then elements, Options are a
0/1 tag.  This mirrors `to_vec` / `from_slice` for the common Python-visible
types so hosts can build `env.write(...)` payloads and decode journals.
"""

from __future__ import annotations

import struct
from typing import Any

WORD = 4


class Writer:
    def __init__(self):
        self.words: list[int] = []

    def write_word(self, w: int):
        self.words.append(w & 0xFFFFFFFF)

    def write_padded_bytes(self, data: bytes):
        pad = (-len(data)) % WORD
        data = data + b"\x00" * pad
        for i in range(0, len(data), WORD):
            self.write_word(int.from_bytes(data[i : i + WORD], "little"))


def _serialize(w: Writer, v: Any):
    if isinstance(v, bool):
        w.write_word(1 if v else 0)
    elif isinstance(v, int):
        if 0 <= v < (1 << 32):
            w.write_word(v)
        elif -(1 << 31) <= v < 0:
            w.write_word(v & 0xFFFFFFFF)
        elif 0 <= v < (1 << 64):
            w.write_padded_bytes(v.to_bytes(8, "little"))
        else:
            raise ValueError(f"int out of range: {v}")
    elif isinstance(v, float):
        w.write_word(struct.unpack("<I", struct.pack("<f", v))[0])
    elif isinstance(v, str):
        b = v.encode()
        w.write_word(len(b))
        w.write_padded_bytes(b)
    elif isinstance(v, (bytes, bytearray)):
        w.write_word(len(v))
        w.write_padded_bytes(bytes(v))
    elif isinstance(v, (list, tuple)):
        if isinstance(v, list):
            w.write_word(len(v))
        for item in v:
            _serialize(w, item)
    elif v is None:
        w.write_word(0)
    else:
        raise TypeError(f"unsupported type: {type(v)}")


def to_vec(value: Any) -> list[int]:
    """Serialize to u32 words (reference serde::to_vec)."""
    w = Writer()
    _serialize(w, value)
    return w.words


def to_bytes(value: Any) -> bytes:
    return b"".join(w.to_bytes(4, "little") for w in to_vec(value))


class Reader:
    def __init__(self, words):
        self.words = list(words)
        self.pos = 0

    def read_word(self) -> int:
        w = self.words[self.pos]
        self.pos += 1
        return int(w)

    def read_padded_bytes(self, n: int) -> bytes:
        nwords = (n + WORD - 1) // WORD
        data = b"".join(
            self.read_word().to_bytes(4, "little") for _ in range(nwords))
        return data[:n]


def from_slice(words, shape: Any) -> Any:
    """Deserialize per a shape spec: int | "u64" | str | bytes | float |
    [elem_shape] (length-prefixed list) | (shape, ...) tuple."""
    return _deserialize(Reader(words), shape)


def _deserialize(r: Reader, shape: Any) -> Any:
    if shape is int:
        return r.read_word()
    if shape == "u64":
        return int.from_bytes(r.read_padded_bytes(8), "little")
    if shape is bool:
        return bool(r.read_word())
    if shape is float:
        return struct.unpack("<f", r.read_word().to_bytes(4, "little"))[0]
    if shape is str:
        n = r.read_word()
        return r.read_padded_bytes(n).decode()
    if shape is bytes:
        n = r.read_word()
        return r.read_padded_bytes(n)
    if isinstance(shape, list):
        n = r.read_word()
        return [_deserialize(r, shape[0]) for _ in range(n)]
    if isinstance(shape, tuple):
        return tuple(_deserialize(r, s) for s in shape)
    raise TypeError(f"unsupported shape: {shape}")
