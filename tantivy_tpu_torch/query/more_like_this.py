"""MoreLikeThisQuery — find docs similar to a reference doc (reference
`src/query/more_like_this/`): extract top TF-IDF terms from the doc's fields,
build a boosted Should-boolean query.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..schema import FieldType
from ..schema.term import Term
from . import BooleanQuery, BoostQuery, Occur, Query, TermQuery, Weight


@dataclass
class MoreLikeThisQuery(Query):
    doc_address: tuple[int, int] | None = None  # (segment_ord, doc_id)
    doc_fields: list[tuple[str, object]] | None = None
    min_doc_frequency: int = 5
    max_doc_frequency: int | None = None
    min_term_frequency: int = 2
    max_query_terms: int = 25
    min_word_length: int = 0
    max_word_length: int = 0
    boost_factor: float = 1.0
    stop_words: frozenset = field(default_factory=frozenset)

    def _per_field_term_freqs(self, searcher) -> dict[str, dict[bytes, int]]:
        if self.doc_fields is not None:
            fields = self.doc_fields
        elif self.doc_address is not None:
            seg_ord, doc_id = self.doc_address
            doc = searcher.segment_readers()[seg_ord].doc(doc_id)
            fields = list(doc.field_values())
        else:
            raise ValueError("MoreLikeThisQuery needs doc_address or doc_fields")

        out: dict[str, dict[bytes, int]] = {}
        for fname, value in fields:
            entry = searcher.schema.get_field(fname)
            if not entry.is_indexed():
                continue
            freqs = out.setdefault(fname, {})
            if entry.field_type == FieldType.TEXT:
                analyzer = searcher.index.tokenizers.get(entry.tokenizer_name())
                for tok in analyzer.token_stream(str(value)):
                    if tok.text in self.stop_words:
                        continue
                    n = len(tok.text)
                    if self.min_word_length and n < self.min_word_length:
                        continue
                    if self.max_word_length and n > self.max_word_length:
                        continue
                    tb = tok.text.encode("utf-8")
                    freqs[tb] = freqs.get(tb, 0) + 1
            elif entry.field_type in (FieldType.U64, FieldType.I64, FieldType.F64,
                                      FieldType.BOOL, FieldType.DATE):
                t = Term(fname, b"")
                from ..indexer.segment_writer import SegmentWriter  # encoding reuse

                # numeric: single term occurrence
                if entry.field_type == FieldType.U64:
                    t = Term.from_field_u64(fname, int(value))
                elif entry.field_type == FieldType.I64:
                    t = Term.from_field_i64(fname, int(value))
                elif entry.field_type == FieldType.F64:
                    t = Term.from_field_f64(fname, float(value))
                elif entry.field_type == FieldType.BOOL:
                    t = Term.from_field_bool(fname, bool(value))
                else:
                    t = Term.from_field_date(fname, int(value))
                freqs[t.value_bytes] = freqs.get(t.value_bytes, 0) + 1
        return out

    def weight(self, searcher, scoring: bool = True) -> Weight:
        per_field = self._per_field_term_freqs(searcher)
        num_docs = max(searcher.num_docs(), 1)
        scored: list[tuple[float, Term]] = []
        for fname, freqs in per_field.items():
            for tb, tf in freqs.items():
                if tf < self.min_term_frequency:
                    continue
                term = Term(fname, tb)
                df = searcher.doc_freq(term)
                if df < self.min_doc_frequency:
                    continue
                if self.max_doc_frequency is not None and df > self.max_doc_frequency:
                    continue
                if df == 0:
                    continue
                idf = math.log(num_docs / df)
                scored.append((tf * idf, term))
        scored.sort(key=lambda x: -x[0])
        clauses = []
        for score, term in scored[: self.max_query_terms]:
            q: Query = TermQuery(term)
            if self.boost_factor != 1.0:
                q = BoostQuery(q, self.boost_factor * score)
            clauses.append((Occur.SHOULD, q))
        return BooleanQuery(clauses).weight(searcher, scoring)
