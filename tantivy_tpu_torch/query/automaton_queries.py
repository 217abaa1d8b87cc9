"""Automaton-driven term expansion queries: fuzzy (Levenshtein) and regex.

Reference: `src/query/fuzzy_query.rs:80` (Levenshtein DFA ∩ FST) and
`regex_query.rs:57`. We evaluate the automaton against the sorted term
dictionary; matching term ords are unioned const-score, like the reference's
`AutomatonWeight` + BitSetDocSet path.

Why these do NOT route to the device kernels: the reference scores
automaton matches CONST (1.0 per doc, no BM25), so there is no tf/idf
arithmetic to accelerate — per query the entire cost is the posting-list
union, which `_MultiTermWeight` already does as one vectorized numpy
union (plus the per-(segment, term) decode LRU shared across a batch).
Expanding into the fused boolean kernel would cap expansions at T_MAX=16
clauses and pay kernel launch + fetch (~55ms fixed) to compute scores the
host derives for free. Top-k of an all-equal-score set is just the first
k doc addresses.
"""

from __future__ import annotations

import re

import numpy as np

from ..schema.term import Term
from . import Query, SegmentResult, Weight, _MultiTermWeight


def levenshtein_within(a: str, b: str, k: int, transposition: bool = False) -> bool:
    """Banded edit distance <= k (Damerau if `transposition`)."""
    if abs(len(a) - len(b)) > k:
        return False
    la, lb = len(a), len(b)
    inf = k + 1
    prev2 = None
    prev = list(range(min(lb, k) + 1)) + [inf] * max(0, lb - k)
    for i in range(1, la + 1):
        cur = [inf] * (lb + 1)
        if i <= k:
            cur[0] = i
        lo = max(1, i - k)
        hi = min(lb, i + k)
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            best = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + cost,
            )
            if (
                transposition
                and i > 1
                and j > 1
                and a[i - 1] == b[j - 2]
                and a[i - 2] == b[j - 1]
            ):
                best = min(best, (prev2[j - 2] if prev2 else inf) + 1)
            cur[j] = best
        prev2, prev = prev, cur
        if min(prev) > k:
            return False
    return prev[lb] <= k


class FuzzyTermQuery(Query):
    """Terms within edit distance `distance` of the target (reference
    `fuzzy_query.rs`); const-score union."""

    def __init__(self, term: Term, distance: int = 1,
                 transposition_cost_one: bool = True, prefix: bool = False):
        self.term = term
        self.distance = distance
        self.transposition = transposition_cost_one
        self.prefix = prefix

    def weight(self, searcher, scoring: bool = True) -> Weight:
        target = self.term.value_bytes.decode("utf-8", errors="replace")
        dist = self.distance
        transposition = self.transposition
        is_prefix = self.prefix

        def ords(inv):
            return inv.termdict.search_levenshtein(
                target, dist, transposition, is_prefix
            )

        return _MultiTermWeight(self.term.field, ords)


class RegexQuery(Query):
    """Terms matching a regex (reference `regex_query.rs`); const-score
    union. The pattern is anchored (full-match), like tantivy-fst's Regex."""

    def __init__(self, pattern: str, field: str):
        self.field = field
        self.pattern = re.compile(pattern)

    @classmethod
    def from_pattern(cls, pattern: str, field: str) -> "RegexQuery":
        return cls(pattern, field)

    def weight(self, searcher, scoring: bool = True) -> Weight:
        pat = self.pattern

        def ords(inv):
            return inv.termdict.search_regex(pat)

        return _MultiTermWeight(self.field, ords)
