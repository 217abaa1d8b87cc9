"""Snippet generation — parity with reference `src/snippet/mod.rs:377`.

`SnippetGenerator.from_searcher(searcher, query, field)` extracts the query's
terms (weighted by idf-like scores), then for a document's text picks the
fragment (<= max_num_chars) whose contained term occurrences score highest,
and renders it with ``<b>`` highlights.
"""

from __future__ import annotations

import html
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Snippet:
    fragment: str
    highlighted: list[tuple[int, int]]  # char ranges into fragment

    def to_html(self) -> str:
        out = []
        pos = 0
        for start, stop in self.highlighted:
            out.append(html.escape(self.fragment[pos:start]))
            out.append("<b>")
            out.append(html.escape(self.fragment[start:stop]))
            out.append("</b>")
            pos = stop
        out.append(html.escape(self.fragment[pos:]))
        return "".join(out)

    def is_empty(self) -> bool:
        return not self.highlighted


def _collect_query_terms(query, field_name: str, out: dict):
    """Walk a query tree collecting term texts for `field_name`."""
    from ..query import (
        BooleanQuery,
        BoostQuery,
        ConstScoreQuery,
        DisjunctionMaxQuery,
        PhraseQuery,
        TermQuery,
    )

    if isinstance(query, TermQuery):
        if query.term.field == field_name:
            out[query.term.value_bytes.decode("utf-8", "replace")] = 1.0
    elif isinstance(query, PhraseQuery):
        if query.field == field_name:
            for tb in query.term_bytes:
                out[tb.decode("utf-8", "replace")] = 1.0
    elif isinstance(query, BooleanQuery):
        from ..query import Occur

        for occ, sub in query.clauses:
            if occ != Occur.MUST_NOT:
                _collect_query_terms(sub, field_name, out)
    elif isinstance(query, (BoostQuery, ConstScoreQuery)):
        _collect_query_terms(query.query, field_name, out)
    elif isinstance(query, DisjunctionMaxQuery):
        for sub in query.queries:
            _collect_query_terms(sub, field_name, out)


class SnippetGenerator:
    DEFAULT_MAX_NUM_CHARS = 150

    def __init__(self, terms_score: dict[str, float], analyzer, field_name: str,
                 max_num_chars: int = DEFAULT_MAX_NUM_CHARS):
        self.terms_score = terms_score
        self.analyzer = analyzer
        self.field_name = field_name
        self.max_num_chars = max_num_chars

    @classmethod
    def from_searcher(cls, searcher, query, field_name: str) -> "SnippetGenerator":
        from ..query.bm25 import idf

        entry = searcher.schema.get_field(field_name)
        analyzer = searcher.index.tokenizers.get(entry.tokenizer_name())
        terms: dict[str, float] = {}
        _collect_query_terms(query, field_name, terms)
        n = max(searcher.max_docs(), 1)
        scored = {}
        for text in terms:
            from ..schema.term import Term

            df = searcher.doc_freq(Term.from_field_text(field_name, text))
            scored[text] = float(idf(df, n)) if df else 1.0
        return cls(scored, analyzer, field_name)

    def set_max_num_chars(self, n: int) -> None:
        self.max_num_chars = n

    def snippet(self, text: str) -> Snippet:
        tokens = [
            t for t in self.analyzer.token_stream(text)
            if t.text in self.terms_score and t.offset_to - t.offset_from <= self.max_num_chars
        ]
        if not tokens:
            return Snippet(text[: self.max_num_chars], [])
        # best window of tokens fitting max_num_chars (reference
        # search_fragments: fragments scored by sum of distinct term scores)
        best_score, best_range = -1.0, (0, 0)
        j = 0
        for i in range(len(tokens)):
            if j < i:
                j = i
            while (
                j + 1 < len(tokens)
                and tokens[j + 1].offset_to - tokens[i].offset_from <= self.max_num_chars
            ):
                j += 1
            seen: dict[str, float] = {}
            for t in tokens[i : j + 1]:
                seen[t.text] = self.terms_score[t.text]
            score = sum(seen.values())
            if score > best_score:
                best_score = score
                best_range = (i, j)
        i, j = best_range
        frag_start = tokens[i].offset_from
        frag_end = min(frag_start + self.max_num_chars, len(text))
        # extend left to start of enclosing region without cutting words badly
        fragment = text[frag_start:frag_end]
        highlights = [
            (t.offset_from - frag_start, min(t.offset_to, frag_end) - frag_start)
            for t in tokens[i : j + 1]
            if t.offset_from < frag_end
        ]
        return Snippet(fragment, highlights)

    def snippet_from_doc(self, doc) -> Snippet:
        parts = [str(v) for v in doc.get_all(self.field_name)]
        return self.snippet(" ".join(parts))
