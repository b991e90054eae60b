# The port's own copy of risc0_tpu/zkvm/proto.py.
"""Minimal protobuf wire-format codec (no protobuf runtime).

Used by the IPC protocol (ipc.py, mirroring reference
risc0/zkvm/src/host/api/{server,client}.rs over api.proto) and the pprof
profiler encoder.  Only varint (wire 0) and length-delimited (wire 2)
fields are needed by either.
"""

from __future__ import annotations


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field_no: int, wire: int) -> bytes:
    return varint((field_no << 3) | wire)


def uint(field_no: int, value: int) -> bytes:
    """Varint field; zero is skipped (proto3 default-value elision)."""
    if value == 0:
        return b""
    return tag(field_no, 0) + varint(int(value))


def bytes_field(field_no: int, payload: bytes) -> bytes:
    return tag(field_no, 2) + varint(len(payload)) + bytes(payload)


def string(field_no: int, s: str) -> bytes:
    return bytes_field(field_no, s.encode()) if s else b""


def packed(field_no: int, values) -> bytes:
    payload = b"".join(varint(int(v)) for v in values)
    return bytes_field(field_no, payload)


def read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = s = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << s
        if not b & 0x80:
            return n, i
        s += 7


def fields(buf: bytes):
    """Yield (field_no, value) pairs; varints as int, delimited as bytes."""
    i = 0
    while i < len(buf):
        t, i = read_varint(buf, i)
        field_no, wire = t >> 3, t & 7
        if wire == 0:
            v, i = read_varint(buf, i)
            yield field_no, v
        elif wire == 2:
            ln, i = read_varint(buf, i)
            yield field_no, buf[i : i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def to_dict(buf: bytes) -> dict:
    """Collect fields; repeated fields become lists."""
    out: dict = {}
    for k, v in fields(buf):
        if k in out:
            prev = out[k]
            if isinstance(prev, list):
                prev.append(v)
            else:
                out[k] = [prev, v]
        else:
            out[k] = v
    return out


def unpack_varints(buf: bytes) -> list[int]:
    out, i = [], 0
    while i < len(buf):
        v, i = read_varint(buf, i)
        out.append(v)
    return out
