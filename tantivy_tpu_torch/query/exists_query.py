"""ExistsQuery — docs where a field has any value (reference
`src/query/exist_query.rs:36`, column-index based).

Memory contract (reference `ARCHITECTURE.md:25-31` O(1)-memory search):
with no fast column, presence resolves from the FIELDNORM byte column for
text fields (a doc has a value iff it produced >= 1 token — exactly the
docs the postings union would yield), and otherwise from a bitmap-
accumulated union of the field's posting lists: peak working memory is
O(max_doc / 8) + one posting list, never the concatenation of every
term's postings."""

from __future__ import annotations

import numpy as np

from ..fastfield import CARD_FULL, CARD_OPTIONAL
from . import Query, SegmentResult, Weight


class ExistsQuery(Query):
    def __init__(self, field: str):
        self.field = field

    def weight(self, searcher, scoring: bool = True) -> Weight:
        return ExistsWeight(self.field)


class ExistsWeight(Weight):
    def __init__(self, field: str):
        self.field = field

    def execute(self, segment_reader) -> SegmentResult:
        col = segment_reader.fast_fields().column(self.field)
        if col is None:
            docs = self._docs_without_column(segment_reader)
            if docs is None:
                return SegmentResult.empty()
            return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))
        if col.cardinality == CARD_FULL:
            docs = np.arange(col.max_doc, dtype=np.uint32)
        elif col.cardinality == CARD_OPTIONAL:
            docs = col.present_docs.astype(np.uint32)
        else:
            docs = np.nonzero(np.diff(col.offsets) > 0)[0].astype(np.uint32)
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))

    def _docs_without_column(self, segment_reader) -> np.ndarray | None:
        try:
            entry = segment_reader.schema.get_field(self.field)
        except (KeyError, ValueError):
            entry = None
        if entry is not None and entry.has_fieldnorms():
            # stored norm id > 0 <=> the doc emitted >= 1 token for this
            # field — identical doc set to the postings union, one u8 scan
            arr = segment_reader._fieldnorm.get(str(entry.field_id))
            if arr is not None:
                return np.nonzero(arr > 0)[0].astype(np.uint32)
            # indexed-with-norms field absent from this segment: no values
            try:
                segment_reader.inverted_index(self.field)
            except KeyError:
                return None
            return np.zeros(0, dtype=np.uint32)
        # no norms (raw tokenizer / numeric / json field): bitmap union of
        # the field's posting lists (reference BitSetDocSet role,
        # `src/query/bitset/mod.rs`) — O(max_doc) bits, one list at a time
        try:
            inv = segment_reader.inverted_index(self.field)
        except KeyError:
            return None
        n_terms = inv.num_terms()
        if n_terms == 0:
            return np.zeros(0, dtype=np.uint32)
        bits = np.zeros(segment_reader.max_doc, dtype=bool)
        for o in range(n_terms):
            docs, _ = inv.read_postings(o)
            bits[docs] = True
        return np.nonzero(bits)[0].astype(np.uint32)
