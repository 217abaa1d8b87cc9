"""Term binary encoding — order-preserving value bytes per field type.

Parity with reference `src/schema/term.rs:22-29` semantics: a term identifies
(field, type, value-bytes) and value bytes sort in natural value order so the
term dictionary's lexicographic order doubles as a value order for ranges.
Mappings follow `common/src/lib.rs` (i64/f64/date -> ordered u64).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


def u64_to_bytes(v: int) -> bytes:
    return struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)


def i64_to_u64(v: int) -> int:
    """Order-preserving i64 -> u64 (flip sign bit)."""
    return (v + (1 << 63)) & 0xFFFFFFFFFFFFFFFF


def u64_to_i64(v: int) -> int:
    return v - (1 << 63)


def f64_to_u64(v: float) -> int:
    """Order-preserving f64 -> u64 (sign-magnitude to biased)."""
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits >> 63:
        return (~bits) & 0xFFFFFFFFFFFFFFFF
    return bits | (1 << 63)


def u64_to_f64(v: int) -> float:
    if v >> 63:
        bits = v & ~(1 << 63)
    else:
        bits = (~v) & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def numeric_keys_u64(values, type_name: str) -> "np.ndarray":
    """Vectorized order-preserving value -> u64 term key for a whole
    column of one numeric type — array parity with `Term.from_field_*`
    (each key's 8-byte big-endian form is the term's value bytes)."""
    import numpy as np

    if type_name == "u64":
        return np.asarray(values, dtype=np.uint64)
    if type_name in ("i64", "date"):
        return (
            np.asarray(values, dtype=np.int64).view(np.uint64)
            ^ np.uint64(1 << 63)
        )
    if type_name == "f64":
        bits = np.asarray(values, dtype=np.float64).view(np.uint64)
        neg = (bits >> np.uint64(63)).astype(bool)
        return np.where(neg, ~bits, bits | np.uint64(1 << 63))
    if type_name == "bool":
        return np.asarray(values, dtype=bool).astype(np.uint64)
    raise TypeError(type_name)


def u64_to_f64_array(raw) -> "np.ndarray":
    """Vectorized `u64_to_f64` over a u64 array (the aggregation read path
    decodes whole 1M-row columns per request)."""
    import numpy as np

    raw = np.asarray(raw, dtype=np.uint64)
    neg_bit = raw >> np.uint64(63)
    bits = np.where(
        neg_bit.astype(bool), raw & ~np.uint64(1 << 63), ~raw
    ).astype(np.uint64)
    return bits.view(np.float64)


def ip_to_bytes(value) -> bytes:
    """IP (str / ipaddress / int) -> order-preserving 16-byte big-endian key;
    IPv4 maps into the IPv6 space (::ffff:a.b.c.d), as the reference does."""
    import ipaddress

    ip = ipaddress.ip_address(value)
    if ip.version == 4:
        ip = ipaddress.IPv6Address(f"::ffff:{ip}")
    return int(ip).to_bytes(16, "big")


def bytes_to_ip(raw: bytes):
    """Inverse of `ip_to_bytes` (returns IPv4Address for mapped addresses)."""
    import ipaddress

    ip = ipaddress.IPv6Address(int.from_bytes(raw, "big"))
    return ip.ipv4_mapped or ip


@dataclass(frozen=True)
class Term:
    field: str
    value_bytes: bytes

    @classmethod
    def from_field_text(cls, field: str, text: str) -> "Term":
        return cls(field, text.encode("utf-8"))

    @classmethod
    def from_field_u64(cls, field: str, value: int) -> "Term":
        return cls(field, u64_to_bytes(value))

    @classmethod
    def from_field_i64(cls, field: str, value: int) -> "Term":
        return cls(field, u64_to_bytes(i64_to_u64(value)))

    @classmethod
    def from_field_f64(cls, field: str, value: float) -> "Term":
        return cls(field, u64_to_bytes(f64_to_u64(value)))

    @classmethod
    def from_field_bool(cls, field: str, value: bool) -> "Term":
        return cls(field, u64_to_bytes(1 if value else 0))

    @classmethod
    def from_field_date(cls, field: str, timestamp_s: int) -> "Term":
        """Date terms are truncated to seconds (reference `term.rs` date
        precision truncation)."""
        return cls(field, u64_to_bytes(i64_to_u64(int(timestamp_s))))

    @classmethod
    def from_field_bytes(cls, field: str, value: bytes) -> "Term":
        return cls(field, bytes(value))

    @classmethod
    def from_field_ip(cls, field: str, value) -> "Term":
        """IP terms are 16-byte big-endian keys (IPv4 mapped into IPv6),
        full u128 precision like the reference's compact-space encoding
        (`columnar/src/column_values/u128_based/`)."""
        return cls(field, ip_to_bytes(value))

    @classmethod
    def from_facet(cls, field: str, facet_path: str) -> "Term":
        """Facet `/a/b` encodes as `a\\x00b` (path-separated bytes)."""
        parts = [p for p in facet_path.split("/") if p != ""]
        return cls(field, b"\x00".join(p.encode("utf-8") for p in parts))

    def text(self) -> str:
        return self.value_bytes.decode("utf-8", errors="replace")
