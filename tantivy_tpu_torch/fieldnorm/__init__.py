"""Field-norm (tokens-per-field-per-doc) 1-byte compression.

Behavioral parity with reference `src/fieldnorm/code.rs`: a 256-entry table
where ids 0..=23 are exact, and above that a 3-bit-mantissa / 5-bit-exponent
float-like code. `fieldnorm_to_id` floors to the largest id whose decoded value
is <= the fieldnorm (reference `code.rs:7-11` binary-search semantics).

The device keeps the raw u8 id array in HBM (one byte per doc per field); BM25
looks norms up through the 256-entry per-query cache (see `query/bm25.py`).
"""

from __future__ import annotations

import numpy as np

_IDENTITY_PART = 24


def _decode_exp_part(b: int) -> int:
    bits = b & 0b111
    shift = b >> 3
    if shift == 0:
        return bits
    return (bits | 8) << (shift - 1)


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        if i < _IDENTITY_PART:
            table[i] = i
        else:
            table[i] = _IDENTITY_PART + _decode_exp_part(i - _IDENTITY_PART)
    return table


#: FIELD_NORMS_TABLE[id] = decoded fieldnorm (number of tokens), parity with
#: reference `code.rs:13` (table checked there against this same formula).
FIELD_NORMS_TABLE: np.ndarray = _build_table()


def id_to_fieldnorm(fieldnorm_id) -> np.ndarray | int:
    """Decode u8 id(s) to fieldnorm value(s)."""
    return FIELD_NORMS_TABLE[fieldnorm_id]


#: direct lookup for small fieldnorms (covers virtually all docs; the
#: searchsorted fallback handles the long tail)
_SMALL_LUT_LIMIT = 1 << 16
_SMALL_LUT = (
    np.searchsorted(
        FIELD_NORMS_TABLE, np.arange(_SMALL_LUT_LIMIT, dtype=np.int64),
        side="right",
    )
    - 1
).astype(np.uint8)


def fieldnorm_to_id(fieldnorm) -> np.ndarray | int:
    """Encode fieldnorm value(s) to the floor id. Vectorized."""
    if np.isscalar(fieldnorm) or np.ndim(fieldnorm) == 0:
        v = int(fieldnorm)
        if 0 <= v < _SMALL_LUT_LIMIT:
            return int(_SMALL_LUT[v])
        return int(np.searchsorted(FIELD_NORMS_TABLE, v, side="right") - 1)
    idx = np.searchsorted(FIELD_NORMS_TABLE, fieldnorm, side="right") - 1
    return idx.astype(np.uint8)


class FieldNormReader:
    """Per-segment, per-field u8 array of fieldnorm ids (reference
    `src/fieldnorm/reader.rs`)."""

    def __init__(self, fieldnorm_ids: np.ndarray):
        self.fieldnorm_ids = np.ascontiguousarray(fieldnorm_ids, dtype=np.uint8)

    @classmethod
    def for_test(cls, fieldnorms) -> "FieldNormReader":
        return cls(fieldnorm_to_id(np.asarray(fieldnorms, dtype=np.uint32)))

    @classmethod
    def constant(cls, max_doc: int, value: int = 0) -> "FieldNormReader":
        ids = np.full(max_doc, fieldnorm_to_id(value), dtype=np.uint8)
        return cls(ids)

    def fieldnorm_id(self, doc: int) -> int:
        return int(self.fieldnorm_ids[doc])

    def fieldnorm(self, doc: int) -> int:
        return int(id_to_fieldnorm(self.fieldnorm_ids[doc]))

    def __len__(self) -> int:
        return len(self.fieldnorm_ids)


class FieldNormsWriter:
    """Records the number of tokens per doc for each indexed field
    (reference `src/fieldnorm/writer.rs`); missing docs get fieldnorm 0."""

    def __init__(self):
        self._per_field: dict[str, list[tuple[int, int]]] = {}

    def record(self, field: str, doc: int, num_tokens: int) -> None:
        self._per_field.setdefault(field, []).append((doc, num_tokens))

    def serialize(self, max_doc: int) -> dict[str, np.ndarray]:
        out = {}
        for field, pairs in self._per_field.items():
            ids = np.zeros(max_doc, dtype=np.uint8)
            for doc, num_tokens in pairs:
                ids[doc] = fieldnorm_to_id(num_tokens)
            out[field] = ids
        return out

    def fields(self):
        return self._per_field.keys()
