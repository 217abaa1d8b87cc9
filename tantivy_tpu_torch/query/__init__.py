"""Query execution — parity with reference `src/query/` (§2.4 of SURVEY.md).

Trait chain mirrors `Query -> Weight -> (docs, scores)`. Where the reference
streams docs through `Scorer: DocSet` cursors, we *materialize* each clause as
sorted `(docs: u32[], scores: f32[])` arrays and combine them with vectorized
set algebra — the same batch shape the device engine uses, so host (numpy) and
device (jnp) paths agree bit-for-bit. Boolean score combination preserves the
reference's f32 summation order (clause order; absent clauses contribute +0.0,
which is exact).

Queries implemented: Term, Boolean (Should/Must/MustNot, min_should_match),
Phrase (with slop), PhrasePrefix, Range (termdict + fastfield), FuzzyTerm,
Regex, TermSet, Exists, All, Empty, Boost, ConstScore, DisjunctionMax,
MoreLikeThis, RegexPhrase (see module files).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from ..schema import FieldType, IndexRecordOption
from ..schema.term import Term
from .bm25 import Bm25Weight


class Occur(str, Enum):
    """Reference `query-grammar/src/occur.rs`."""

    SHOULD = "should"
    MUST = "must"
    MUST_NOT = "must_not"


@dataclass
class SegmentResult:
    """Materialized matches of one weight over one segment: docs sorted
    ascending, unique; scores aligned (1.0 if scoring disabled)."""

    docs: np.ndarray  # uint32, sorted unique
    scores: np.ndarray  # float32

    @classmethod
    def empty(cls) -> "SegmentResult":
        return cls(np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.float32))


def member_lookup(sorted_docs: np.ndarray, probes: np.ndarray):
    """Vectorized membership: returns (found: bool[], idx: int[]) of `probes`
    in `sorted_docs`."""
    if len(sorted_docs) == 0:
        return (
            np.zeros(len(probes), dtype=bool),
            np.zeros(len(probes), dtype=np.int64),
        )
    idx = np.searchsorted(sorted_docs, probes)
    safe = np.minimum(idx, len(sorted_docs) - 1)
    found = sorted_docs[safe] == probes
    return found, safe


class Query:
    def weight(self, searcher, scoring: bool = True) -> "Weight":
        raise NotImplementedError

    def explain(self, searcher, doc_address) -> "Explanation":
        """Score explanation tree for one document (reference
        `query.rs:138`); raises DoesNotMatchError if the doc doesn't
        match."""
        from .explanation import DoesNotMatchError

        w = self.weight(searcher, scoring=True)
        reader = searcher.segment_readers()[doc_address.segment_ord]
        if reader.is_deleted(doc_address.doc_id):
            raise DoesNotMatchError(doc_address.doc_id)
        return w.explain(reader, doc_address.doc_id)

    def count(self, searcher) -> int:
        w = self.weight(searcher, scoring=False)
        total = 0
        for reader in searcher.segment_readers():
            total += w.count(reader)
        return total


class Weight:
    def execute(self, segment_reader) -> SegmentResult:
        """All matching docs + scores in this segment (deletes NOT applied —
        collectors apply the alive bitset, like reference
        `collector/mod.rs:186-221`)."""
        raise NotImplementedError

    def topk(self, segment_reader, k: int,
             threshold=np.float32(-np.inf)) -> SegmentResult:
        """Pruned evaluation for top-k collection — the host analogue of
        reference `Weight::for_each_pruning` (`weight.rs:123-132`). May omit
        any doc whose score is <= `threshold` (the caller's kth score
        accumulated from strictly-earlier DocAddresses, so equal scores
        lose the tie-break) or provably outside this segment's top-k.
        Deletes ARE applied (unlike execute). Default: full evaluation."""
        res = self.execute(segment_reader)
        alive = segment_reader.alive_bitset()
        docs, scores = res.docs, res.scores
        if alive is not None and len(docs):
            m = alive[docs]
            docs, scores = docs[m], scores[m]
        if threshold > np.float32(-np.inf) and len(docs):
            m = scores > threshold
            docs, scores = docs[m], scores[m]
        return SegmentResult(docs, scores)

    def count(self, segment_reader) -> int:
        res = self.execute(segment_reader)
        alive = segment_reader.alive_bitset()
        if alive is None:
            return len(res.docs)
        return int(np.count_nonzero(alive[res.docs]))

    def explain(self, segment_reader, doc: int) -> "Explanation":
        """Generic explanation: the doc's score with no breakdown
        (specialized weights override with formula trees, reference
        `weight.rs:75`)."""
        from .explanation import DoesNotMatchError, Explanation

        res = self.execute(segment_reader)
        i = np.searchsorted(res.docs, doc)
        if i >= len(res.docs) or res.docs[i] != doc:
            raise DoesNotMatchError(doc)
        return Explanation(type(self).__name__, res.scores[i])


# ---------------------------------------------------------------------------
# Term


class TermQuery(Query):
    """Reference `term_query/`."""

    def __init__(self, term: Term, record: IndexRecordOption = IndexRecordOption.WITH_FREQS):
        self.term = term
        self.record = record

    def __repr__(self):
        return f"TermQuery({self.term.field}:{self.term.value_bytes!r})"

    def weight(self, searcher, scoring: bool = True,
               boost: float = 1.0) -> "TermWeight":
        if scoring:
            stats = searcher.term_statistics(self.term)
            bm25 = Bm25Weight.for_one_term(
                max(stats.doc_freq, 1), stats.total_num_docs, stats.average_fieldnorm
            )
        else:
            bm25 = None
        return TermWeight(self.term, bm25, scoring and self.record.has_freq(),
                          boost=boost)


class TermWeight(Weight):
    def __init__(self, term: Term, bm25: Bm25Weight | None, with_freqs: bool = True,
                 boost: float = 1.0):
        self.term = term
        self.bm25 = bm25.boost_by(boost) if (bm25 and boost != 1.0) else bm25
        self.with_freqs = with_freqs

    def execute(self, segment_reader) -> SegmentResult:
        inv = segment_reader.inverted_index(self.term.field)
        ord_ = inv.term_ord(self.term.value_bytes)
        if ord_ is None:
            return SegmentResult.empty()
        docs, tfs = inv.read_postings(ord_)
        if self.bm25 is None:
            scores = np.ones(len(docs), dtype=np.float32)
        else:
            norm_ids = segment_reader.fieldnorms(self.term.field)[docs]
            scores = self.bm25.score(norm_ids, tfs)
        return SegmentResult(docs, np.asarray(scores, dtype=np.float32))

    def count(self, segment_reader) -> int:
        if segment_reader.alive_bitset() is None:
            # O(1): doc_freq straight from the term dictionary
            return segment_reader.inverted_index(self.term.field).doc_freq(
                self.term.value_bytes
            )
        return super().count(segment_reader)

    def explain(self, segment_reader, doc: int):
        """BM25 breakdown (reference `term_weight.rs:41-53`)."""
        from .explanation import DoesNotMatchError, Explanation

        inv = segment_reader.inverted_index(self.term.field)
        ord_ = inv.term_ord(self.term.value_bytes)
        if ord_ is None:
            raise DoesNotMatchError(doc)
        docs, tfs = inv.read_postings(ord_)
        i = np.searchsorted(docs, doc)
        if i >= len(docs) or docs[i] != doc:
            raise DoesNotMatchError(doc)
        if self.bm25 is None:
            expl = Explanation("TermQuery, no scoring", np.float32(1.0))
        else:
            fnid = segment_reader.fieldnorms(self.term.field)[doc]
            expl = self.bm25.explain(int(fnid), int(tfs[i]))
        expl.add_context(f"Term={self.term!r}")
        return expl


# ---------------------------------------------------------------------------
# Boolean


class BooleanQuery(Query):
    """Reference `boolean_query/`. Score = sum of matching clause scores in
    clause order; MustNot excludes; `minimum_number_should_match` filters."""

    def __init__(self, clauses: list[tuple[Occur, Query]],
                 minimum_number_should_match: int = 0):
        self.clauses = list(clauses)
        self.minimum_number_should_match = minimum_number_should_match

    @classmethod
    def union(cls, queries: list[Query]) -> "BooleanQuery":
        return cls([(Occur.SHOULD, q) for q in queries])

    @classmethod
    def intersection(cls, queries: list[Query]) -> "BooleanQuery":
        return cls([(Occur.MUST, q) for q in queries])

    def __repr__(self):
        return f"BooleanQuery({[(o.value, q) for o, q in self.clauses]!r})"

    def weight(self, searcher, scoring: bool = True) -> "BooleanWeight":
        sub = [
            (occur, q.weight(searcher, scoring and occur != Occur.MUST_NOT))
            for occur, q in self.clauses
        ]
        return BooleanWeight(sub, scoring, self.minimum_number_should_match)


class BooleanWeight(Weight):
    def __init__(self, weights: list[tuple[Occur, Weight]], scoring: bool,
                 minimum_number_should_match: int = 0):
        self.weights = weights
        self.scoring = scoring
        self.min_should = minimum_number_should_match

    def explain(self, segment_reader, doc: int):
        """Sum of matching positive clause explanations (reference
        `boolean_weight.rs:483-500`)."""
        from .explanation import DoesNotMatchError, Explanation

        res = self.execute(segment_reader)
        i = np.searchsorted(res.docs, doc)
        if i >= len(res.docs) or res.docs[i] != doc:
            raise DoesNotMatchError(doc)
        if not self.scoring:
            return Explanation("BooleanQuery with no scoring", 1.0)
        expl = Explanation("BooleanClause. sum of ...", res.scores[i])
        for occ, sub in self.weights:
            if occ == Occur.MUST_NOT:
                continue
            try:
                expl.add_detail(sub.explain(segment_reader, doc))
            except ValueError:
                pass
        return expl

    def execute(self, segment_reader) -> SegmentResult:
        musts = [(i, w) for i, (o, w) in enumerate(self.weights) if o == Occur.MUST]
        shoulds = [(i, w) for i, (o, w) in enumerate(self.weights) if o == Occur.SHOULD]
        must_nots = [w for o, w in self.weights if o == Occur.MUST_NOT]
        if not musts and not shoulds:
            return SegmentResult.empty()

        results: dict[int, SegmentResult] = {}
        for i, w in musts + shoulds:
            results[i] = w.execute(segment_reader)

        # candidate doc set
        if musts:
            cand = results[musts[0][0]].docs
            for i, _ in musts[1:]:
                found, _ = member_lookup(results[i].docs, cand)
                cand = cand[found]
        else:
            cand = np.unique(np.concatenate([results[i].docs for i, _ in shoulds]))

        min_should = self.min_should
        if not musts:
            min_should = max(min_should, 1)
        if shoulds and min_should > 0:
            count = np.zeros(len(cand), dtype=np.int32)
            for i, _ in shoulds:
                found, _ = member_lookup(results[i].docs, cand)
                count += found
            cand = cand[count >= min_should]
        elif not shoulds and min_should > len(shoulds):
            return SegmentResult.empty()

        for w in must_nots:
            excl = w.execute(segment_reader)
            found, _ = member_lookup(excl.docs, cand)
            cand = cand[~found]

        if not self.scoring:
            return SegmentResult(cand, np.ones(len(cand), dtype=np.float32))

        # sum scores clause-order (absent contributes exact +0.0)
        scores = np.zeros(len(cand), dtype=np.float32)
        for i, _ in sorted(musts + shoulds):
            res = results[i]
            if len(res.docs) == 0:
                continue
            found, idx = member_lookup(res.docs, cand)
            contrib = np.where(found, res.scores[idx], np.float32(0.0))
            scores = (scores + contrib).astype(np.float32)
        return SegmentResult(cand, scores)


# ---------------------------------------------------------------------------
# Wrappers


class AllQuery(Query):
    """Matches all documents with score 1.0 (reference `all_query.rs`)."""

    def weight(self, searcher, scoring: bool = True) -> "Weight":
        return AllWeight()


class AllWeight(Weight):
    def execute(self, segment_reader) -> SegmentResult:
        docs = np.arange(segment_reader.max_doc, dtype=np.uint32)
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))

    def count(self, segment_reader) -> int:
        # O(1): num_docs from the manifest — no arange materialization
        # (reference all_query.rs Weight::count)
        alive = segment_reader.alive_bitset()
        if alive is None:
            return int(segment_reader.max_doc)
        return int(np.count_nonzero(alive))


class EmptyQuery(Query):
    def weight(self, searcher, scoring: bool = True) -> "Weight":
        return EmptyWeight()


class EmptyWeight(Weight):
    def execute(self, segment_reader) -> SegmentResult:
        return SegmentResult.empty()


class BoostQuery(Query):
    """score * boost (reference `boost_query.rs`).

    Boost FOLDS into the inner weight when the inner query is a TermQuery
    (reference `boost_query.rs` passes `boost * self.boost` down the
    `Weight::scorer` chain, so the BM25 weight itself is boosted); other
    inner queries multiply scores post-hoc (`BoostWeight`). Folding is what
    lets boosted term clauses ride the device kernels bit-exactly."""

    def __init__(self, query: Query, boost: float):
        self.query = query
        self.boost = float(boost)

    def term_and_boost(self):
        """(inner TermQuery, cumulative f32 boost) if this (possibly
        nested) boost wraps a plain term, else None."""
        boost = np.float32(1.0)
        q = self
        while isinstance(q, BoostQuery):
            boost = np.float32(boost * np.float32(q.boost))
            q = q.query
        if isinstance(q, TermQuery):
            return q, boost
        return None

    def weight(self, searcher, scoring: bool = True) -> "Weight":
        tb = self.term_and_boost()
        if tb is not None and scoring:
            return tb[0].weight(searcher, True, boost=float(tb[1]))
        return BoostWeight(self.query.weight(searcher, scoring), self.boost)


class BoostWeight(Weight):
    def __init__(self, inner: Weight, boost: float):
        self.inner = inner
        self.boost = np.float32(boost)

    def execute(self, segment_reader) -> SegmentResult:
        res = self.inner.execute(segment_reader)
        return SegmentResult(res.docs, (res.scores * self.boost).astype(np.float32))

    def count(self, segment_reader) -> int:
        return self.inner.count(segment_reader)


class ConstScoreQuery(Query):
    """Wraps a query, every match scores `score` (reference
    `const_score_query.rs`)."""

    def __init__(self, query: Query, score: float):
        self.query = query
        self.score = float(score)

    def weight(self, searcher, scoring: bool = True) -> "Weight":
        return ConstScoreWeight(self.query.weight(searcher, False), self.score)


class ConstScoreWeight(Weight):
    def __init__(self, inner: Weight, score: float):
        self.inner = inner
        self.score = np.float32(score)

    def execute(self, segment_reader) -> SegmentResult:
        res = self.inner.execute(segment_reader)
        return SegmentResult(
            res.docs, np.full(len(res.docs), self.score, dtype=np.float32)
        )

    def count(self, segment_reader) -> int:
        return self.inner.count(segment_reader)


class DisjunctionMaxQuery(Query):
    """max(clause scores) + tie_breaker * sum(other scores) (reference
    `disjunction_max_query.rs`)."""

    def __init__(self, queries: list[Query], tie_breaker: float = 0.0):
        self.queries = list(queries)
        self.tie_breaker = float(tie_breaker)

    def weight(self, searcher, scoring: bool = True) -> "Weight":
        return DisjunctionMaxWeight(
            [q.weight(searcher, scoring) for q in self.queries], self.tie_breaker
        )


class DisjunctionMaxWeight(Weight):
    def __init__(self, weights: list[Weight], tie_breaker: float):
        self.inner = weights
        self.tie_breaker = np.float32(tie_breaker)

    def execute(self, segment_reader) -> SegmentResult:
        results = [w.execute(segment_reader) for w in self.inner]
        if not results:
            return SegmentResult.empty()
        cand = np.unique(np.concatenate([r.docs for r in results]))
        best = np.zeros(len(cand), dtype=np.float32)
        total = np.zeros(len(cand), dtype=np.float32)
        for r in results:
            if len(r.docs) == 0:
                continue
            found, idx = member_lookup(r.docs, cand)
            sc = np.where(found, r.scores[idx], np.float32(0.0)).astype(np.float32)
            best = np.maximum(best, sc)
            total = (total + sc).astype(np.float32)
        scores = (best + self.tie_breaker * (total - best)).astype(np.float32)
        return SegmentResult(cand, scores)


# ---------------------------------------------------------------------------
# Multi-term expansion helpers (range/fuzzy/regex/set/exists share this)


class _MultiTermWeight(Weight):
    """Union of many terms of one field, scored constantly 1.0 (the reference
    scores multi-term expansions with ConstScore via BitSetDocSet)."""

    def __init__(self, field: str, ords_fn):
        self.field = field
        self._ords_fn = ords_fn  # (inverted_index) -> iterable[int]

    def execute(self, segment_reader) -> SegmentResult:
        inv = segment_reader.inverted_index(self.field)
        parts = []
        for ord_ in self._ords_fn(inv):
            docs, _ = inv.read_postings(ord_)
            parts.append(docs)
        if not parts:
            return SegmentResult.empty()
        docs = np.unique(np.concatenate(parts))
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))


class TermSetQuery(Query):
    """Docs containing any of a set of terms (reference `set_query.rs`);
    scores are const 1.0."""

    def __init__(self, terms: list[Term]):
        if not terms:
            self.field = None
        else:
            self.field = terms[0].field
        by_field: dict[str, list[bytes]] = {}
        for t in terms:
            by_field.setdefault(t.field, []).append(t.value_bytes)
        self.by_field = {f: sorted(set(v)) for f, v in by_field.items()}

    def weight(self, searcher, scoring: bool = True) -> "Weight":
        weights = []
        for field, values in self.by_field.items():
            def ords(inv, values=values):
                out = []
                for v in values:
                    o = inv.term_ord(v)
                    if o is not None:
                        out.append(o)
                return out

            weights.append(_MultiTermWeight(field, ords))
        if len(weights) == 1:
            return weights[0]
        return _UnionConstWeight(weights)


class _UnionConstWeight(Weight):
    def __init__(self, weights: list[Weight]):
        self.inner = weights

    def execute(self, segment_reader) -> SegmentResult:
        parts = [w.execute(segment_reader).docs for w in self.inner]
        parts = [p for p in parts if len(p)]
        if not parts:
            return SegmentResult.empty()
        docs = np.unique(np.concatenate(parts))
        return SegmentResult(docs, np.ones(len(docs), dtype=np.float32))


from .range_query import RangeQuery  # noqa: E402,F401
from .phrase_query import PhraseQuery, PhrasePrefixQuery  # noqa: E402,F401
from .automaton_queries import FuzzyTermQuery, RegexQuery  # noqa: E402,F401
from .exists_query import ExistsQuery  # noqa: E402,F401
from .more_like_this import MoreLikeThisQuery  # noqa: E402,F401
