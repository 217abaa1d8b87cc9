"""Facet counting — parity with reference `src/collector/facet_collector.rs`
(hierarchical facet counts over path-encoded facet terms).

Facets index as one term per path prefix (`/a/b` -> `a`, `a\\x00b`; see
`tokenizer.FacetTokenizer`), so counting the children of a root is: for every
term that is a direct child of the root, count matching docs in its postings.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..query import member_lookup
from . import Collector, _alive_filter


class Facet:
    def __init__(self, path: str):
        self.parts = [p for p in path.split("/") if p != ""]

    @classmethod
    def from_encoded(cls, encoded: bytes) -> "Facet":
        f = cls("")
        f.parts = [p.decode("utf-8", "replace") for p in encoded.split(b"\x00")]
        return f

    def to_path_string(self) -> str:
        return "/" + "/".join(self.parts)

    def encoded(self) -> bytes:
        return b"\x00".join(p.encode("utf-8") for p in self.parts)

    def __repr__(self):
        return f"Facet({self.to_path_string()})"

    def __eq__(self, other):
        return isinstance(other, Facet) and self.parts == other.parts

    def __hash__(self):
        return hash(tuple(self.parts))


class FacetCounts:
    def __init__(self, counts: Counter):
        self._counts = counts

    def get(self, root: str) -> list[tuple[Facet, int]]:
        """Counts of direct children of `root`, sorted by path."""
        root_parts = [p for p in root.split("/") if p != ""]
        out = []
        for facet, count in self._counts.items():
            if len(facet.parts) == len(root_parts) + 1 and facet.parts[: len(root_parts)] == root_parts:
                out.append((facet, count))
        out.sort(key=lambda x: x[0].parts)
        return out

    def top_k(self, root: str, k: int) -> list[tuple[Facet, int]]:
        children = self.get(root)
        children.sort(key=lambda x: (-x[1], x[0].parts))
        return children[:k]


class FacetCollector(Collector):
    def __init__(self, field: str):
        self.field = field
        self._roots: list[list[str]] = []

    def add_facet(self, root: str) -> None:
        self._roots.append([p for p in root.split("/") if p != ""])

    def collect_segment(self, weight, segment_ord: int, reader) -> Counter:
        res = weight.execute(reader)
        docs, _ = _alive_filter(res, reader)
        counts: Counter = Counter()
        if len(docs) == 0:
            return counts
        inv = reader.inverted_index(self.field)
        for root_parts in self._roots or [[]]:
            prefix = b"\x00".join(p.encode("utf-8") for p in root_parts)
            if prefix:
                child_prefix = prefix + b"\x00"
            else:
                child_prefix = b""
            for ord_ in inv.termdict.prefix_ords(child_prefix):
                term = inv.termdict.term(ord_)
                # direct children only
                rest = term[len(child_prefix):]
                if b"\x00" in rest:
                    continue
                tdocs, _ = inv.read_postings(ord_)
                found, _ = member_lookup(tdocs, docs)
                n = int(np.count_nonzero(found))
                if n:
                    counts[Facet.from_encoded(term)] += n
        return counts

    def merge_fruits(self, fruits: list[Counter]) -> FacetCounts:
        total: Counter = Counter()
        for f in fruits:
            total.update(f)
        return FacetCounts(total)
