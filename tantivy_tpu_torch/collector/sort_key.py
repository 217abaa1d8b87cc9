"""General TopDocs sort keys — parity with reference `src/collector/sort_key/`.

A *sort key computer* maps each matching doc to a key component; TopDocs
collects the k GREATEST keys under the component comparators (the reference
"TopDocs reverses the order" convention, `sort_key_computer.rs`), with the
universal tie-break DocAddress ascending (`top_score_collector.rs:503-507`).

Components:
* `SortByScore()` — the BM25 similarity score (`sort_by_score.rs:12`);
* `SortByFastField(field)` — first fast-field value; missing -> None
  (`sort_by_static_fast_value.rs:35`, strings `sort_by_string.rs:31`,
  bytes `sort_by_bytes.rs:28`);
* `SortByCallable(fn)` — custom: `fn(reader) -> (doc, score) -> key`
  (`sort_key_computer.rs:455` closure impls).

Comparators mirror `order.rs`:
* `natural`             — greatest first; None lowest (appears last);
* `reverse`             — smallest first; None treated greatest (first);
* `reverse_none_lower`  — smallest first, None last  (== Order "asc");
* `natural_none_higher` — greatest first, None first.

`(computer, "asc"/"desc")` pairs map to comparators exactly like
`impl From<Order> for ComparatorEnum` (`order.rs:287-292`): asc ->
reverse_none_lower, desc -> natural. Tuples of components compare
lexicographically (`order.rs:314-405` tuple impls, up to 4).
"""

from __future__ import annotations

from functools import cmp_to_key
from typing import Callable

import numpy as np

from ..searcher import DocAddress

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

#: comparator -> (missing_rank_first, ascending_values)
#: missing_rank_first: None keys outrank every value (appear first in out)
#: ascending_values: smaller raw values outrank larger ones
_COMPARATORS = {
    "natural": (False, False),
    "reverse": (True, True),
    "reverse_none_lower": (False, True),
    "natural_none_higher": (True, False),
}


def comparator_of(order: str) -> str:
    """Order -> ComparatorEnum (`order.rs:287-292`)."""
    if order in _COMPARATORS:
        return order
    if order == "asc":
        return "reverse_none_lower"
    if order == "desc":
        return "natural"
    raise ValueError(f"unknown order {order!r}")


class SortByScore:
    requires_scoring = True

    def segment_keys(self, reader, docs, scores):
        # f32 scores are order-preserved by their sign-flip u64 embedding
        v = np.ascontiguousarray(
            scores + np.float32(0.0), dtype=np.float32
        ).view(np.uint32).astype(np.uint64)
        raw = np.where(
            v & np.uint64(0x80000000),
            np.uint64(0x80000000) - (v ^ np.uint64(0x80000000)) - np.uint64(1),
            v + np.uint64(0x80000000),
        )
        return raw, np.ones(len(docs), dtype=bool)

    def decode(self, reader, raw: int):
        # inverse of the sign-flip embedding in segment_keys
        u = int(raw)
        if u >= 0x80000000:
            bits = np.uint32(u - 0x80000000)
        else:
            bits = np.uint32((0x7FFFFFFF - u) | 0x80000000)
        return np.float32(bits.view(np.float32))


class SortByFastField:
    requires_scoring = False

    def __init__(self, field: str):
        self.field = field

    def segment_keys(self, reader, docs, scores):
        col = reader.fast_fields().column(self.field)
        if col is None or len(docs) == 0:
            return (
                np.zeros(len(docs), dtype=np.uint64),
                np.zeros(len(docs), dtype=bool),
            )
        raw, present = col.first_u64s(docs)
        return raw.astype(np.uint64, copy=False), present

    def decode(self, reader, raw: int):
        col = reader.fast_fields().column(self.field)
        return col.decode_value(int(raw))


class SortByCallable:
    """Custom sort key: `fn(reader)` returns a per-doc callable
    `(doc, score) -> key`; keys must be mutually comparable numbers."""

    requires_scoring = True

    def __init__(self, fn: Callable):
        self.fn = fn

    def segment_keys(self, reader, docs, scores):
        seg_fn = self.fn(reader)
        vals = np.asarray(
            [float(seg_fn(int(d), float(s))) for d, s in zip(docs, scores)],
            dtype=np.float64,
        )
        v = vals.view(np.uint64)
        raw = np.where(
            v & np.uint64(0x8000000000000000),
            ~v,
            v | np.uint64(0x8000000000000000),
        )
        return raw, np.ones(len(docs), dtype=bool)

    def decode(self, reader, raw: int):
        u = np.uint64(raw)
        if u & np.uint64(0x8000000000000000):
            bits = u ^ np.uint64(0x8000000000000000)
        else:
            bits = ~u
        return float(np.uint64(bits).view(np.float64))


def _normalize(computers) -> list[tuple[object, str]]:
    """Accepts a computer, a (computer, order) pair, or a tuple/list of
    either (up to 4, like the reference tuple impls)."""
    if isinstance(computers, tuple) and len(computers) == 2 and isinstance(
        computers[1], str
    ):
        computers = [computers]
    elif not isinstance(computers, (list, tuple)):
        computers = [computers]
    out = []
    for item in computers:
        if isinstance(item, tuple):
            comp, order = item
        else:
            comp, order = item, "desc"
        out.append((comp, comparator_of(order)))
    if not 1 <= len(out) <= 4:
        raise ValueError("sort keys support 1..4 components")
    return out


class TopDocsBySortKey:
    """Reference `TopDocs::order_by` (`top_score_collector.rs:322`): top-k
    under lexicographic component comparators, DocAddress-ascending
    tie-break. Fruit entries: (key_tuple_or_scalar, DocAddress)."""

    def __init__(self, limit: int, offset: int, computers):
        self.limit = limit
        self.offset = offset
        self.components = _normalize(computers)

    def requires_scoring(self) -> bool:
        return any(c.requires_scoring for c, _ in self.components)

    def collect_segment(self, weight, segment_ord: int, reader):
        from . import _alive_filter

        res = weight.execute(reader)
        docs, scores = _alive_filter(res, reader)
        if len(docs) == 0:
            return []
        sort_cols = []  # lexsort keys, PRIMARY LAST
        comps = []
        for comp, cname in self.components:
            raw, present = comp.segment_keys(reader, docs, scores)
            none_first, asc = _COMPARATORS[cname]
            # rank columns ascending = output order
            miss_rank = (
                present.astype(np.uint8)
                if none_first
                else (~present).astype(np.uint8)
            )
            val_rank = np.where(
                present, raw if asc else _U64MAX - raw, np.uint64(0)
            )
            comps.append((comp, raw, present))
            sort_cols.append((miss_rank, val_rank))
        keys = [docs]
        for miss_rank, val_rank in reversed(sort_cols):
            keys.append(val_rank)
            keys.append(miss_rank)
        order = np.lexsort(tuple(keys))[: self.limit + self.offset]
        out = []
        for i in order:
            vals = tuple(
                comp.decode(reader, raw[i]) if present[i] else None
                for comp, raw, present in comps
            )
            key = vals[0] if len(vals) == 1 else vals
            out.append((key, DocAddress(segment_ord, int(docs[i]))))
        return out

    def _cmp(self, a, b) -> int:
        """Reference ordering of two fruit entries: component comparators
        lexicographically (GREATEST first), then DocAddress ascending."""
        ka = a[0] if isinstance(a[0], tuple) else (a[0],)
        kb = b[0] if isinstance(b[0], tuple) else (b[0],)
        for (comp, cname), va, vb in zip(self.components, ka, kb):
            none_first, asc = _COMPARATORS[cname]
            if va is None or vb is None:
                if va is None and vb is None:
                    continue
                wins_a = (va is None) == none_first
                return -1 if wins_a else 1
            if va != vb:
                lt = _value_lt(va, vb)
                wins_a = lt if asc else not lt
                return -1 if wins_a else 1
        return -1 if a[1] < b[1] else (1 if a[1] > b[1] else 0)

    def merge_fruits(self, fruits):
        all_hits = [hit for fruit in fruits for hit in fruit]
        all_hits.sort(key=cmp_to_key(self._cmp))
        return all_hits[self.offset : self.offset + self.limit]


def _value_lt(a, b) -> bool:
    """Cross-type less-than for decoded sort values (homogeneous columns
    in practice; numbers compare numerically like `compare_owned_value`)."""
    if isinstance(a, (bytes, str)) or isinstance(b, (bytes, str)):
        return a < b
    return float(a) < float(b)
