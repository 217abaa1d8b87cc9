"""Searcher — point-in-time snapshot over segment readers (reference
`src/core/searcher.rs:69`).

Also provides the index-global BM25 statistics (doc_freq / total tokens across
segments — reference `Bm25StatisticsProvider`, `bm25.rs:27-50`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True, order=True)
class DocAddress:
    """(segment ordinal, doc id) — reference `src/lib.rs` DocAddress."""

    segment_ord: int
    doc_id: int


@dataclass
class TermStatistics:
    doc_freq: int
    total_num_docs: int
    average_fieldnorm: np.float32


@dataclass
class FieldStatistics:
    total_num_docs: int
    average_fieldnorm: np.float32


class Searcher:
    def __init__(self, index, segment_readers: list):
        self.index = index
        self.schema = index.schema
        self._segment_readers = list(segment_readers)

    def segment_readers(self) -> list:
        return self._segment_readers

    def num_docs(self) -> int:
        """Number of alive docs."""
        return sum(r.num_docs() for r in self._segment_readers)

    def max_docs(self) -> int:
        """Total docs incl. deleted (reference total_num_docs uses max_doc)."""
        return sum(r.max_doc for r in self._segment_readers)

    def doc(self, address: DocAddress):
        return self._segment_readers[address.segment_ord].doc(address.doc_id)

    def docs(self, addresses: list) -> list:
        """Batched document fetch, input-order results. Addresses group by
        segment and fetch in doc-id order so each ~16KB store block
        decompresses once and stays hot in the LRU while its docs drain
        (reference `store/reader.rs:25,63` block cache)."""
        out = [None] * len(addresses)
        by_seg: dict[int, list[int]] = {}
        for i, a in enumerate(addresses):
            by_seg.setdefault(a.segment_ord, []).append(i)
        for seg, idxs in by_seg.items():
            reader = self._segment_readers[seg]
            idxs.sort(key=lambda i: addresses[i].doc_id)
            for i in idxs:
                out[i] = reader.doc(addresses[i].doc_id)
        return out

    def doc_freq(self, term) -> int:
        return sum(
            r.inverted_index(term.field).doc_freq(term.value_bytes)
            for r in self._segment_readers
        )

    def total_num_tokens(self, field: str) -> int:
        return sum(
            r.inverted_index(field).total_num_tokens() for r in self._segment_readers
        )

    def field_statistics(self, field: str) -> FieldStatistics:
        # average_fieldnorm = total tokens / total docs, f32 division
        # (reference bm25.rs:109-111 uses max_doc per segment)
        total_docs = self.max_docs()
        total_tokens = self.total_num_tokens(field)
        avg = np.float32(total_tokens) / np.float32(max(total_docs, 1))
        return FieldStatistics(total_docs, avg)

    def term_statistics(self, term) -> TermStatistics:
        fs = self.field_statistics(term.field)
        return TermStatistics(self.doc_freq(term), fs.total_num_docs, fs.average_fieldnorm)

    # -- search --------------------------------------------------------------

    def search(self, query, collector, executor=None):
        """Reference `core/searcher.rs:220` search_with_executor.

        `collector` may be a tuple of collectors (reference tuple
        collectors, `collector/mod.rs:322`): the result is the tuple of
        their fruits, collected in one pass."""
        if isinstance(collector, tuple):
            from .collector import MultiCollector

            names = [f"c{i}" for i in range(len(collector))]
            multi = MultiCollector(**dict(zip(names, collector)))
            out = self.search(query, multi, executor)
            return tuple(out[n] for n in names)
        scoring = collector.requires_scoring()
        weight = query.weight(self, scoring=scoring)
        if executor is None:
            executor = getattr(self.index, "search_executor", None)
        if executor is None and hasattr(collector, "collect_segments_pruned"):
            # sequential threshold-carrying drive (reference
            # for_each_pruning, weight.rs:123-132)
            return collector.collect_segments_pruned(
                weight, self._segment_readers
            )
        if executor is not None:
            fruits = executor.map(
                lambda pair: collector.collect_segment(weight, pair[0], pair[1]),
                list(enumerate(self._segment_readers)),
            )
        else:
            fruits = [
                collector.collect_segment(weight, ord_, reader)
                for ord_, reader in enumerate(self._segment_readers)
            ]
        return collector.merge_fruits(fruits)

    def doc_store_cache_stats(self):
        hits = sum(r.store_reader().cache_stats.cache_hits for r in self._segment_readers)
        misses = sum(
            r.store_reader().cache_stats.cache_misses for r in self._segment_readers
        )
        return {"cache_hits": hits, "cache_misses": misses}

    def space_usage(self):
        from collections import defaultdict

        total = defaultdict(int)
        per_segment = []
        for r in self._segment_readers:
            su = r.space_usage()
            per_segment.append(su)
            for k, v in su.items():
                total[k] += v
        return {"total": dict(total), "segments": per_segment}
