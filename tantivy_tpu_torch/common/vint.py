"""Variable-length u32/u64 integers (LEB128-style, 7 bits per byte).

Behavioral parity with reference `common/src/vint.rs` (continuation-bit
encoding, little-endian groups of 7 bits). Used for on-disk metadata; the hot
posting-block path never touches VInts on device.
"""

from __future__ import annotations


def write_vint(value: int) -> bytes:
    if value < 0:
        raise ValueError("vint must be non-negative")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_vint(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, new_offset)."""
    result = 0
    shift = 0
    while True:
        b = data[offset]
        offset += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, offset
        shift += 7
