"""Collectors — parity with reference `src/collector/` (§2.5 of SURVEY.md).

`collect_segment(weight, segment_ord, reader) -> fruit` then
`merge_fruits(fruits)` — the same two-phase shape as the reference
(`collector/mod.rs:141-221`), which is also exactly the per-device /
cross-device split of the sharded search path (`parallel/`).

Tie-break contract (reference `top_score_collector.rs:503-507`): sort key
descending, then DocAddress ascending.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ..searcher import DocAddress


class Collector:
    def requires_scoring(self) -> bool:
        return False

    def collect_segment(self, weight, segment_ord: int, reader) -> Any:
        raise NotImplementedError

    def merge_fruits(self, fruits: list[Any]) -> Any:
        raise NotImplementedError


def _alive_filter(res, reader):
    alive = reader.alive_bitset()
    if alive is None or len(res.docs) == 0:
        return res.docs, res.scores
    mask = alive[res.docs]
    return res.docs[mask], res.scores[mask]


def top_k_by_score(docs: np.ndarray, scores: np.ndarray, k: int):
    """Top-k with (score desc, doc asc) tie-break; returns (docs, scores)
    sorted. Exact counterpart of TopNComputer ordering."""
    if len(docs) == 0 or k == 0:
        return docs[:0], scores[:0]
    if len(docs) > 4 * k:
        # tie-aware partial select: keep everything >= the k-th score, then
        # order exactly. Ties at the boundary survive for the doc-asc
        # tie-break below.
        kth = np.partition(scores, len(scores) - k)[len(scores) - k]
        keep = scores >= kth
        docs, scores = docs[keep], scores[keep]
    order = np.lexsort((docs, -scores.astype(np.float64)))[:k]
    return docs[order], scores[order]


class TopDocs(Collector):
    """Reference `top_score_collector.rs:61` — top-k by BM25 score with
    optional offset, or by a fast field / custom key via `order_by_*`."""

    def __init__(self, limit: int, offset: int = 0):
        if limit < 1:
            raise ValueError("limit must be >= 1")
        self.limit = limit
        self.offset = offset

    def and_offset(self, offset: int) -> "TopDocs":
        return TopDocs(self.limit, offset)

    def order_by_u64_field(self, field: str, descending: bool = True):
        return TopDocsByField(self.limit, self.offset, field, descending)

    def order_by_fast_field(self, field: str, descending: bool = True):
        return TopDocsByField(self.limit, self.offset, field, descending)

    def order_by_string_fast_field(self, field: str, descending: bool = True):
        """Order by a string fast field (reference
        `top_score_collector.rs:312`): per-segment ordinal sort, decoded
        terms merge across segments."""
        return TopDocsByField(self.limit, self.offset, field, descending)

    def order_by_score(self) -> "TopDocs":
        return self

    def order_by(self, computers):
        """General (SortKeyComputer, Order) sort keys, incl. lexicographic
        tuples of up to 4 components (reference
        `top_score_collector.rs:322`, `collector/sort_key/`). `computers`
        is a component, a `(component, "asc"/"desc")` pair, or a list of
        either; components are `SortByScore()`, `SortByFastField(field)`,
        or `SortByCallable(fn)` (see `collector/sort_key.py`)."""
        from .sort_key import TopDocsBySortKey

        return TopDocsBySortKey(self.limit, self.offset, computers)

    def tweak_score(self, score_fn: Callable):
        return TopDocsTweaked(self.limit, self.offset, score_fn)

    def requires_scoring(self) -> bool:
        return True

    def collect_segment(self, weight, segment_ord: int, reader,
                        threshold=np.float32(-np.inf)):
        res = weight.topk(reader, self.limit + self.offset, threshold)
        docs, scores = _alive_filter(res, reader)
        k = self.limit + self.offset
        docs, scores = top_k_by_score(docs, scores, k)
        return [
            (np.float32(s), DocAddress(segment_ord, int(d)))
            for d, s in zip(docs, scores)
        ]

    def collect_segments_pruned(self, weight, readers):
        """Sequential per-segment collection carrying a rising threshold —
        the host analogue of the reference's for_each_pruning drive
        (`sort_key_top_collector.rs:62-73`): segment N is pruned with the
        kth score accumulated over segments < N (all strictly-earlier
        DocAddresses, so equal scores lose the tie-break and `topk` may
        drop score <= threshold)."""
        k = self.limit + self.offset
        fruits = []
        hits: list = []
        th = np.float32(-np.inf)
        for ord_, reader in enumerate(readers):
            fruit = self.collect_segment(weight, ord_, reader, threshold=th)
            fruits.append(fruit)
            hits.extend(fruit)
            if len(hits) >= k:
                hits.sort(key=lambda x: (-float(x[0]), x[1]))
                del hits[k:]
                th = np.float32(hits[-1][0])
        return self.merge_fruits(fruits)

    def merge_fruits(self, fruits):
        all_hits = [hit for fruit in fruits for hit in fruit]
        all_hits.sort(key=lambda x: (-float(x[0]), x[1]))
        return all_hits[self.offset : self.offset + self.limit]


class TopDocsByField(Collector):
    """Order by a fast field value (reference `order_by_fast_field`,
    `collector/sort_key/`). Fruit entries: (value, DocAddress)."""

    def __init__(self, limit: int, offset: int, field: str, descending: bool = True):
        self.limit = limit
        self.offset = offset
        self.field = field
        self.descending = descending

    def requires_scoring(self) -> bool:
        return False

    def collect_segment(self, weight, segment_ord: int, reader):
        res = weight.execute(reader)
        docs, _ = _alive_filter(res, reader)
        col = reader.fast_fields().column(self.field)
        if col is None or len(docs) == 0:
            return []
        # raw u64 values are order-preserving -> sort vectorized, decode
        # only the surviving page
        raw, present = col.first_u64s(docs)
        docs, raw = docs[present], raw[present]
        key = (np.iinfo(np.uint64).max - raw) if self.descending else raw
        order = np.lexsort((docs, key))[: self.limit + self.offset]
        return [
            (col.decode_value(raw[i]), DocAddress(segment_ord, int(docs[i])))
            for i in order
        ]

    def merge_fruits(self, fruits):
        all_hits = [hit for fruit in fruits for hit in fruit]
        all_hits.sort(key=lambda x: x[1])  # DocAddress asc (stable)
        all_hits.sort(key=lambda x: x[0], reverse=self.descending)
        return all_hits[self.offset : self.offset + self.limit]


class TopDocsTweaked(Collector):
    """tweak_score: per-segment closure rescores (score, doc) (reference
    `TopDocs::tweak_score`)."""

    def __init__(self, limit: int, offset: int, score_fn: Callable):
        self.limit = limit
        self.offset = offset
        self.score_fn = score_fn

    def requires_scoring(self) -> bool:
        return True

    def collect_segment(self, weight, segment_ord: int, reader):
        segment_scorer = self.score_fn(reader)
        res = weight.execute(reader)
        docs, scores = _alive_filter(res, reader)
        tweaked = np.asarray(
            [segment_scorer(int(d), float(s)) for d, s in zip(docs, scores)],
            dtype=np.float64,
        )
        if len(docs) == 0:
            return []
        order = np.lexsort((docs, -tweaked))[: self.limit + self.offset]
        return [
            (tweaked[i], DocAddress(segment_ord, int(docs[i]))) for i in order
        ]

    def merge_fruits(self, fruits):
        all_hits = [hit for fruit in fruits for hit in fruit]
        all_hits.sort(key=lambda x: (-x[0], x[1]))
        return all_hits[self.offset : self.offset + self.limit]


class Count(Collector):
    """Reference `count_collector.rs` — uses Weight.count (O(1) for term
    queries without deletes)."""

    def collect_segment(self, weight, segment_ord: int, reader) -> int:
        return weight.count(reader)

    def merge_fruits(self, fruits: list[int]) -> int:
        return int(sum(fruits))


class DocSetCollector(Collector):
    """All matching DocAddresses (reference `docset_collector.rs`)."""

    def collect_segment(self, weight, segment_ord: int, reader):
        res = weight.execute(reader)
        docs, _ = _alive_filter(res, reader)
        return {DocAddress(segment_ord, int(d)) for d in docs}

    def merge_fruits(self, fruits):
        out = set()
        for f in fruits:
            out |= f
        return out


class FilterCollector(Collector):
    """Filter docs by a fast-field predicate before delegating (reference
    `filter_collector_wrapper.rs`)."""

    def __init__(self, field: str, predicate: Callable, inner: Collector):
        self.field = field
        self.predicate = predicate
        self.inner = inner

    def requires_scoring(self) -> bool:
        return self.inner.requires_scoring()

    def collect_segment(self, weight, segment_ord: int, reader):
        col = reader.fast_fields().column(self.field)
        pred = self.predicate

        class _FilteredWeight:
            def __init__(self, w):
                self._w = w

            def execute(self, r):
                res = self._w.execute(r)
                from ..query import SegmentResult

                if col is None or len(res.docs) == 0:
                    return SegmentResult(
                        res.docs[:0], res.scores[:0]
                    )
                # evaluate the predicate once per DISTINCT value, then
                # scatter to docs (any-match semantics for multi-value)
                from ..aggregation import _column_ords_raw

                raw, idx = _column_ords_raw(col, res.docs)
                mask = np.zeros(len(res.docs), dtype=bool)
                if len(raw):
                    uniq, inv = np.unique(raw, return_inverse=True)
                    okv = np.fromiter(
                        (bool(pred(col.decode_value(u))) for u in uniq),
                        dtype=bool, count=len(uniq),
                    )
                    mask[idx[okv[inv]]] = True
                return SegmentResult(res.docs[mask], res.scores[mask])

            def count(self, r):
                return len(self.execute(r).docs)

        return self.inner.collect_segment(_FilteredWeight(weight), segment_ord, reader)

    def merge_fruits(self, fruits):
        return self.inner.merge_fruits(fruits)


class MultiCollector(Collector):
    """Run several collectors in one pass (reference `multi_collector.rs`)."""

    def __init__(self, **collectors: Collector):
        self.collectors = collectors

    def requires_scoring(self) -> bool:
        return any(c.requires_scoring() for c in self.collectors.values())

    def collect_segment(self, weight, segment_ord: int, reader):
        return {
            name: c.collect_segment(weight, segment_ord, reader)
            for name, c in self.collectors.items()
        }

    def merge_fruits(self, fruits):
        return {
            name: c.merge_fruits([f[name] for f in fruits])
            for name, c in self.collectors.items()
        }


class HistogramCollector(Collector):
    """Fixed-width histogram over a fast field (reference
    `histogram_collector.rs`)."""

    def __init__(self, field: str, min_value: float, bucket_width: float,
                 num_buckets: int):
        self.field = field
        self.min_value = min_value
        self.bucket_width = bucket_width
        self.num_buckets = num_buckets

    def collect_segment(self, weight, segment_ord: int, reader):
        from ..aggregation import _column_values

        res = weight.execute(reader)
        docs, _ = _alive_filter(res, reader)
        counts = np.zeros(self.num_buckets, dtype=np.int64)
        vals, _ = _column_values(reader, self.field, docs)
        if len(vals):
            b = np.floor((vals - self.min_value) / self.bucket_width).astype(
                np.int64
            )
            sel = (b >= 0) & (b < self.num_buckets)
            counts += np.bincount(b[sel], minlength=self.num_buckets)
        return counts

    def merge_fruits(self, fruits):
        total = np.zeros(self.num_buckets, dtype=np.int64)
        for f in fruits:
            total += f
        return total
