"""Range queries (reference `src/query/range_query/`).

Two execution paths like the reference: fast-field column scan when the field
is FAST (`range_query_fastfield.rs`), else term-dictionary range union
(`range_query.rs` -> BitSetDocSet). Both yield const-score 1.0 matches.
"""

from __future__ import annotations

import numpy as np

from ..fastfield import CARD_FULL, CARD_MULTI, CARD_OPTIONAL, to_u64
from ..schema import FieldType
from ..schema.term import Term
from . import Query, SegmentResult, Weight


class RangeQuery(Query):
    def __init__(
        self,
        field: str,
        lower=None,
        upper=None,
        include_lower: bool = True,
        include_upper: bool = True,
    ):
        self.field = field
        self.lower = lower
        self.upper = upper
        self.include_lower = include_lower
        self.include_upper = include_upper

    def __repr__(self):
        lb = "[" if self.include_lower else "{"
        ub = "]" if self.include_upper else "}"
        return f"RangeQuery({self.field}:{lb}{self.lower} TO {self.upper}{ub})"

    def weight(self, searcher, scoring: bool = True) -> Weight:
        try:
            entry = searcher.schema.get_field(self.field)
        except KeyError:
            # `json_field.path` over a FAST json field's dynamic columns
            # (reference `range_query_fastfield.rs` + `readers.rs:64-101`)
            if "." in self.field:
                parts = self.field.split(".")
                for i in range(len(parts) - 1, 0, -1):
                    name = ".".join(parts[:i])
                    try:
                        base = searcher.schema.get_field(name)
                    except KeyError:
                        continue
                    if base.field_type == FieldType.JSON and base.is_fast():
                        return JsonPathRangeWeight(self)
            raise
        if entry.is_fast() and entry.field_type == FieldType.IP_ADDR:
            return DictRangeWeight(self, entry)
        if entry.is_fast() and entry.field_type not in (
            FieldType.TEXT, FieldType.BYTES,
        ):
            return FastFieldRangeWeight(self, entry)
        return TermRangeWeight(self, entry)


def _term_bytes(entry, value) -> bytes:
    ftype = entry.field_type
    if ftype == FieldType.TEXT:
        return Term.from_field_text(entry.name, str(value)).value_bytes
    if ftype == FieldType.U64:
        return Term.from_field_u64(entry.name, int(value)).value_bytes
    if ftype == FieldType.I64:
        return Term.from_field_i64(entry.name, int(value)).value_bytes
    if ftype == FieldType.F64:
        return Term.from_field_f64(entry.name, float(value)).value_bytes
    if ftype == FieldType.BOOL:
        return Term.from_field_bool(entry.name, bool(value)).value_bytes
    if ftype == FieldType.DATE:
        return Term.from_field_date(entry.name, int(value)).value_bytes
    if ftype == FieldType.BYTES:
        return bytes(value)
    if ftype == FieldType.IP_ADDR:
        from ..schema.term import ip_to_bytes

        return ip_to_bytes(value)
    raise TypeError(f"range over unsupported field type {ftype}")


class TermRangeWeight(Weight):
    def __init__(self, query: RangeQuery, entry):
        self.q = query
        self.entry = entry

    def execute(self, segment_reader) -> SegmentResult:
        inv = segment_reader.inverted_index(self.q.field)
        lower = (
            _term_bytes(self.entry, self.q.lower) if self.q.lower is not None else None
        )
        upper = (
            _term_bytes(self.entry, self.q.upper) if self.q.upper is not None else None
        )
        ords = inv.termdict.range_ords(
            lower, upper, self.q.include_lower, self.q.include_upper
        )
        if len(ords) == 0:
            return SegmentResult.empty()
        # bitmap-accumulated union (reference `range_query.rs` collects the
        # term range into a BitSetDocSet, `src/query/bitset/mod.rs`): peak
        # memory is O(max_doc) bits + one posting list, not the
        # concatenation of every term's postings
        bits = np.zeros(segment_reader.max_doc, dtype=bool)
        for o in ords:
            docs, _ = inv.read_postings(o)
            bits[docs] = True
        docs = np.nonzero(bits)[0].astype(np.uint32)
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))


class DictRangeWeight(Weight):
    """Range over a dictionary-encoded fast column (str/bytes/ip): the
    sorted per-segment dictionary is an order-preserving compact space
    (the u128 compact-space idea of reference
    `columnar/src/column_values/u128_based/compact_space/`), so byte-range
    bounds become one ordinal interval and the column scan is a pure u64
    vector comparison."""

    def __init__(self, query: RangeQuery, entry):
        self.q = query
        self.entry = entry

    def execute(self, segment_reader) -> SegmentResult:
        col = segment_reader.fast_fields().column(self.entry.name)
        if col is None or col.dictionary is None:
            return SegmentResult.empty()
        lower = (
            _term_bytes(self.entry, self.q.lower)
            if self.q.lower is not None
            else None
        )
        upper = (
            _term_bytes(self.entry, self.q.upper)
            if self.q.upper is not None
            else None
        )
        rng = col.dictionary.range_ords(
            lower, upper, self.q.include_lower, self.q.include_upper
        )
        if len(rng) == 0:
            return SegmentResult.empty()
        lo_u, hi_u = np.uint64(rng.start), np.uint64(rng.stop - 1)
        mask = (col.values >= lo_u) & (col.values <= hi_u)
        if col.cardinality == CARD_FULL:
            docs = np.nonzero(mask)[0].astype(np.uint32)
        elif col.cardinality == CARD_OPTIONAL:
            docs = col.present_docs[mask].astype(np.uint32)
        else:
            hit_rows = np.nonzero(mask)[0]
            docs = np.unique(
                (np.searchsorted(col.offsets, hit_rows, side="right") - 1).astype(
                    np.uint32
                )
            )
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))


class FastFieldRangeWeight(Weight):
    """Column scan (reference `range_query_fastfield.rs`). The dense u64
    column comparison is a pure vector op — the device path maps it directly
    onto the VPU."""

    def __init__(self, query: RangeQuery, entry):
        self.q = query
        self.entry = entry

    def _bounds_u64(self) -> tuple[int, int]:
        type_name = self.entry.field_type.value
        lo = 0
        hi = 0xFFFFFFFFFFFFFFFF
        if self.q.lower is not None:
            lo = to_u64(self.q.lower, type_name)
            if not self.q.include_lower:
                lo += 1
        if self.q.upper is not None:
            hi = to_u64(self.q.upper, type_name)
            if not self.q.include_upper:
                if hi == 0:
                    return 1, 0
                hi -= 1
        return lo, hi

    def execute(self, segment_reader) -> SegmentResult:
        col = segment_reader.fast_fields().column(self.entry.name)
        if col is None:
            return SegmentResult.empty()
        lo, hi = self._bounds_u64()
        if lo > hi:
            return SegmentResult.empty()
        lo_u, hi_u = np.uint64(lo), np.uint64(hi)
        if col.cardinality == CARD_FULL:
            mask = (col.values >= lo_u) & (col.values <= hi_u)
            docs = np.nonzero(mask)[0].astype(np.uint32)
        elif col.cardinality == CARD_OPTIONAL:
            mask = (col.values >= lo_u) & (col.values <= hi_u)
            docs = col.present_docs[mask].astype(np.uint32)
        else:  # MULTI
            mask = (col.values >= lo_u) & (col.values <= hi_u)
            hit_rows = np.nonzero(mask)[0]
            docs = np.unique(
                (np.searchsorted(col.offsets, hit_rows, side="right") - 1).astype(
                    np.uint32
                )
            )
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))


def _mask_to_docs(col, mask) -> np.ndarray:
    if col.cardinality == CARD_FULL:
        return np.nonzero(mask)[0].astype(np.uint32)
    if col.cardinality == CARD_OPTIONAL:
        return col.present_docs[mask].astype(np.uint32)
    hit_rows = np.nonzero(mask)[0]
    return np.unique(
        (np.searchsorted(col.offsets, hit_rows, side="right") - 1)
        .astype(np.uint32)
    )


class JsonPathRangeWeight(Weight):
    """Range over a FAST json field's dynamic per-path column. The value
    type is per-segment (the column's own type), so bounds convert at
    execute time; str paths range over the dictionary ordinals."""

    def __init__(self, query: RangeQuery):
        self.q = query

    def execute(self, segment_reader) -> SegmentResult:
        col = segment_reader.fast_fields().column(self.q.field)
        if col is None:
            return SegmentResult.empty()
        if col.dictionary is not None:
            enc = (
                lambda v: v.encode("utf-8") if isinstance(v, str)
                else bytes(v)
            )
            rng = col.dictionary.range_ords(
                enc(self.q.lower) if self.q.lower is not None else None,
                enc(self.q.upper) if self.q.upper is not None else None,
                self.q.include_lower, self.q.include_upper,
            )
            if len(rng) == 0:
                return SegmentResult.empty()
            mask = (col.values >= np.uint64(rng.start)) & (
                col.values <= np.uint64(rng.stop - 1)
            )
        else:
            lo, hi = 0, 0xFFFFFFFFFFFFFFFF
            if self.q.lower is not None:
                lo = to_u64(self.q.lower, col.type_name)
                if not self.q.include_lower:
                    lo += 1
            if self.q.upper is not None:
                hi = to_u64(self.q.upper, col.type_name)
                if not self.q.include_upper:
                    if hi == 0:
                        return SegmentResult.empty()
                    hi -= 1
            if lo > hi:
                return SegmentResult.empty()
            mask = (col.values >= np.uint64(lo)) & (
                col.values <= np.uint64(hi)
            )
        docs = _mask_to_docs(col, mask)
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))
