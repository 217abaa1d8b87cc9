"""The one traffic generator: batches of query strings in the
search-benchmark-game's syntax, drawn from the seed by a mix's parameters.

A mix (`traffic/<name>.json`) gives the batch size, k, and a list of
`forms`, each with its `share` of a batch and the term counts it cycles
through:

* `term`: one term, `w1`;
* `or`: the terms separated by spaces, `w1 w2 w3` (SHOULD clauses);
* `and`: each term with a `+`, `+w1 +w2` (MUST clauses);
* `phrase`: consecutive tokens of the stream in quotes, `"w1 w2"`, so
  that each phrase occurs in the corpus.

Terms of `term`, `or` and `and` are drawn in proportion to their count in
the stream among the words seen at least MIN_COUNT times, so that common
words dominate as in query logs; a query's terms differ from each other.
Every batch holds the same number of queries of each (form, term count),
in an order drawn from the seed, and its draws are stratified: a batch's
terms fall one in each of equal strata of the words' count distribution,
and its phrases one in each of equal strata of the phrases ordered by
their tokens' summed counts. So seeds change which terms and phrases are
asked, and barely how much work a batch asks for.
"""

from __future__ import annotations

import numpy as np

from .corpus import rng_for

FORMS = ("term", "or", "and", "phrase")
#: words seen fewer times in the stream are never a query term
MIN_COUNT = 5

#: what a query string looks like, by form
_JOIN = {
    "term": lambda ws: ws[0],
    "or": lambda ws: " ".join(ws),
    "and": lambda ws: " ".join("+" + w for w in ws),
    "phrase": lambda ws: '"' + " ".join(ws) + '"',
}


def batch_slots(mix: dict) -> list[tuple[dict, int]]:
    """The (form entry, term count) of each query of a batch, before
    shuffling: each form's share of the batch by largest remainder, and
    inside a form its term counts in turn."""
    forms = mix["forms"]
    for f in forms:
        if f["form"] not in FORMS:
            raise ValueError(f"unknown query form {f['form']!r}; "
                             f"forms: {FORMS}")
    n = mix["batch"]
    total = sum(f["share"] for f in forms)
    exact = [n * f["share"] / total for f in forms]
    counts = [int(x) for x in exact]
    rest = sorted(range(len(forms)), key=lambda i: counts[i] - exact[i])
    for i in rest[:n - sum(counts)]:
        counts[i] += 1
    slots = []
    for f, c in zip(forms, counts):
        widths = f["terms"]
        slots += [(f, widths[j % len(widths)]) for j in range(c)]
    return slots


def stratified(rng, n: int) -> np.ndarray:
    """`n` points of [0, 1), one in each of `n` equal strata, shuffled:
    draws that follow a distribution as closely as `n` draws can."""
    u = (np.arange(n) + rng.random(n)) / n
    rng.shuffle(u)
    return u


def repair_distinct(groups: list[list[int]], rng) -> None:
    """Swaps values between groups until no group holds one twice (each
    group's length and the multiset of all values stay as they are)."""
    flat = [(g, j) for g, grp in enumerate(groups) for j in range(len(grp))]
    for g, grp in enumerate(groups):
        for j in range(len(grp)):
            tries = 0
            while grp.count(grp[j]) > 1 and tries < 1000:
                tries += 1
                h, i = flat[int(rng.integers(len(flat)))]
                if h == g:
                    continue
                a, b = grp[j], groups[h][i]
                if b in grp or a in groups[h]:
                    continue
                grp[j], groups[h][i] = b, a


class Traffic:
    """The query strings of one mix over one corpus."""

    def __init__(self, mix: dict, corpus, seed: int):
        self.mix = mix
        self.batch = mix["batch"]
        self.k = mix["k"]
        self.seed = seed
        self.words = corpus.words
        self.stream = corpus.stream
        self.slots = batch_slots(mix)
        ids, counts = np.unique(corpus.stream, return_counts=True)
        keep = counts >= MIN_COUNT
        self.pool = ids[keep]
        self.cdf = np.cumsum(counts[keep]) / counts[keep].sum()
        count_of = np.zeros(len(corpus.words), dtype=np.int64)
        count_of[ids] = counts
        self.count_of = count_of
        self._by_cost: dict[int, np.ndarray] = {}

    def _draw_terms(self, rng, n: int) -> list[int]:
        """`n` pool indices drawn by their words' counts in the stream,
        stratified over the counts' distribution."""
        at = np.searchsorted(self.cdf, stratified(rng, n), side="right")
        return np.minimum(at, len(self.pool) - 1).tolist()

    def phrase_starts(self, n: int) -> np.ndarray:
        """The stream's starts of `n`-token phrases, ordered by the summed
        counts of their tokens (the work a phrase makes), then by start."""
        got = self._by_cost.get(n)
        if got is None:
            m = len(self.stream) - n + 1
            cost = sum(self.count_of[self.stream[j:j + m]] for j in range(n))
            got = self._by_cost[n] = np.argsort(cost, kind="stable")
        return got

    def _draw_phrases(self, rng, n: int, count: int) -> list[list[str]]:
        """`count` phrases of `n` tokens at stream positions drawn uniformly,
        stratified over the phrases' summed token counts."""
        order = self.phrase_starts(n)
        at = order[(stratified(rng, count) * len(order)).astype(np.int64)]
        return [self.words[self.stream[p:p + n]].tolist() for p in at]

    def batch_at(self, index: int, purpose: int = 0) -> list[str]:
        """Batch `index` of the log: the same strings for the same seed,
        mix and corpus. `purpose` keeps warm-up batches apart from the
        measured ones. Each form's terms (or phrases of one length) are
        drawn together, stratified, so that every batch asks about as much
        work as every other."""
        rng = rng_for(self.seed, 10 + purpose, index)
        words: list = [None] * len(self.slots)
        groups: dict[tuple, list[int]] = {}
        for j, (f, n) in enumerate(self.slots):
            key = (id(f), n) if f["form"] == "phrase" else (id(f),)
            groups.setdefault(key, []).append(j)
        for key, js in groups.items():
            f, n = self.slots[js[0]]
            if f["form"] == "phrase":
                for j, ws in zip(js, self._draw_phrases(rng, n, len(js))):
                    words[j] = ws
                continue
            sizes = [self.slots[j][1] for j in js]
            drawn = self._draw_terms(rng, sum(sizes))
            parts, at = [], 0
            for s in sizes:
                parts.append(drawn[at:at + s])
                at += s
            repair_distinct(parts, rng)
            for j, p in zip(js, parts):
                words[j] = self.words[self.pool[p]].tolist()
        return [_JOIN[self.slots[j][0]["form"]](words[j])
                for j in rng.permutation(len(self.slots))]
