"""The plain reference: each query's exact BM25 top-k, worked out again
from the generated corpus and the query strings alone.

It imports nothing of the program and reads nothing it made. It follows
tantivy's semantics for the query strings the traffic generator writes:

* the query syntax of the search-benchmark-game: `w1` (a term),
  `+w1 +w2` (MUST clauses), `w1 w2 w3` (SHOULD clauses), `-w1` (MUST_NOT),
  `"w1 w2"` (a phrase, slop 0); a clause that is one bare term is the
  query itself;
* the default tokenizer: split on characters that are not alphanumeric,
  drop tokens of 40 UTF-8 bytes or more, lowercase;
* the u8 fieldnorm code: ids 0..23 exact, then a float-like code of a
  3-bit mantissa and a 5-bit exponent (tantivy `fieldnorm/code.rs`), a
  document's length read back as the largest code at or below it;
* BM25 in float32 with k1 = 1.2 and b = 0.75 over all segments' document
  count and average fieldnorm (total tokens over total documents, a
  float32 division); idf = ln(1 + (N - n + 0.5) / (n + 0.5)) taken with
  numpy's float32 `log1p`, the repository's BM25 (`tantivy_tpu/query/
  bm25.py`), where tantivy takes `(1.0 + x).ln()`; a phrase weighs the sum of its terms' idfs,
  added in order, and counts its slop-0 occurrences as its frequency;
* a boolean query's score is the sum of its matching positive clauses'
  scores in clause order, from 0.0;
* hits ordered by score descending, then by address (segment, doc id)
  ascending, cut at k; the address comes from the commit schedule.

Over several text fields (the parser's default fields, in order) a bare
term or a quoted phrase is what tantivy's parser makes of it: a boolean of
SHOULD clauses, one a field, whose score is the sum of the matching
fields' scores in field order, from 0.0; `+x` and `-x` are MUST and
MUST_NOT over that nested boolean, which matches where any field matches,
and the outer sum goes in clause order as above. Each field has its own
document frequencies (idf over all documents), its own average fieldnorm
(the field's total tokens over all documents, a float32 division) and its
own fieldnorm id a document; a phrase's positions never cross a field's
window. This is the order in which the port's host engine sums
(`BooleanWeight.execute`). One field is the case of one summand: 0.0 + s
is s, so its scores are those of the one-field arithmetic above.

Every float32 operation goes through `Arith`, so that the same code, with
`Arith("bfloat16")`, is the control: the reference in the precision below
the configuration's float32.
"""

from __future__ import annotations

import re

import numpy as np

K1 = 1.2
B = 0.75
#: tokens this long in UTF-8 bytes or longer are dropped
TOKEN_LIMIT = 40
#: fieldnorm ids below this decode to themselves
FIELDNORM_EXACT = 24
#: terms whose per-document frequencies the reference keeps
TF_CACHE = 64


class Arith:
    """float32 arithmetic, each result rounded to `precision`: "float32"
    (IEEE single, as numpy computes it) or "bfloat16" (rounded to nearest
    even on 8 bits of mantissa after every operation)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def r(self, x):
        x = np.asarray(x, dtype=np.float32)
        if self.precision == "float32":
            return x
        u = x.view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32)

    def add(self, a, b):
        return self.r(self.r(a) + self.r(b))

    def sub(self, a, b):
        return self.r(self.r(a) - self.r(b))

    def mul(self, a, b):
        return self.r(self.r(a) * self.r(b))

    def div(self, a, b):
        return self.r(self.r(a) / self.r(b))

    def log1p(self, a):
        return self.r(np.log1p(self.r(a), dtype=np.float32))


def tokenize(text: str) -> list[str]:
    """The default tokenizer's tokens of `text`."""
    out, cur = [], []
    for ch in text + " ":
        if ch.isalnum():
            cur.append(ch)
        elif cur:
            tok = "".join(cur)
            cur = []
            if len(tok.encode("utf-8")) < TOKEN_LIMIT:
                out.append(tok.lower())
    return out


def fieldnorm_table() -> np.ndarray:
    """The decoded value of each of the 256 fieldnorm ids."""
    table = np.zeros(256, dtype=np.int64)
    for i in range(256):
        if i < FIELDNORM_EXACT:
            table[i] = i
            continue
        code = i - FIELDNORM_EXACT
        mantissa, exponent = code & 7, code >> 3
        table[i] = FIELDNORM_EXACT + (
            mantissa if exponent == 0 else (mantissa | 8) << (exponent - 1))
    return table


FIELDNORMS = fieldnorm_table()


def fieldnorm_id(n_tokens: np.ndarray) -> np.ndarray:
    return np.searchsorted(FIELDNORMS, n_tokens, side="right") - 1


_QUERY_TOKEN = re.compile(r'([+-]?)(?:"([^"]*)"|(\S+))')


def parse(query: str) -> tuple:
    """A query string as ("term", token), ("phrase", [tokens]) or
    ("bool", [(occur, ("term" | "phrase", ...)), ...])."""
    clauses = []
    for m in _QUERY_TOKEN.finditer(query):
        sign, quoted, bare = m.groups()
        toks = tokenize(quoted if quoted is not None else bare)
        if not toks:
            continue
        if len(toks) > 1 and quoted is None:
            raise ValueError(f"{bare!r}: a bare word of several tokens is "
                             "not in the benchmark's syntax")
        sub = ("term", toks[0]) if len(toks) == 1 else ("phrase", toks)
        occur = {"+": "must", "-": "must_not", "": None}[sign]
        clauses.append((occur, sub))
    if len(clauses) == 1 and clauses[0][0] is None:
        return clauses[0][1]
    return ("bool", [(occ or "should", sub) for occ, sub in clauses])


class Field:
    """One text field's windows and each document's BM25 length factor,
    K1 * (1 - B + B * dl / avgdl), by its fieldnorm id."""

    def __init__(self, name: str, starts, ends, a: Arith):
        self.name, self.starts, self.ends = name, starts, ends
        lengths = ends - starts
        avg = a.div(np.float32(int(lengths.sum())), np.float32(len(lengths)))
        dl = FIELDNORMS.astype(np.float32)
        norm = a.mul(np.float32(K1), a.add(
            a.sub(np.float32(1.0), np.float32(B)),
            a.div(a.mul(np.float32(B), dl), avg)))
        self.doc_norm = norm[fieldnorm_id(lengths)]


class Reference:
    """The answers of one corpus: `topk(query, k)` gives [(score bits,
    segment, doc id)] in rank order."""

    def __init__(self, corpus, arith: Arith | None = None):
        self.c = corpus
        self.a = arith or Arith()
        tok_of_word = []
        for w in corpus.words.tolist():
            toks = tokenize(w)
            if len(toks) != 1:
                raise ValueError(f"vocabulary word {w!r} gives {len(toks)} "
                                 "tokens; the reference reads one a word")
            tok_of_word.append(toks[0])
        self.token_ids: dict[str, int] = {}
        word_tok = np.array([self.token_ids.setdefault(t, len(self.token_ids))
                             for t in tok_of_word], dtype=np.int32)
        self.tokens = word_tok[corpus.stream]
        self.n_docs = corpus.n_docs
        self.fields = [Field(name, s, e, self.a)
                       for name, (s, e) in corpus.fields.items()]
        self._tf: dict[tuple, np.ndarray] = {}

    def _count(self, toks: tuple, f: Field) -> np.ndarray:
        """Each document's count of slop-0 occurrences of `toks` in field
        `f` (its term frequency for one token)."""
        got = self._tf.get((f.name, toks))
        if got is not None:
            return got
        n = len(toks)
        ids = [self.token_ids.get(t, -1) for t in toks]
        L = len(self.tokens)
        if min(ids) < 0 or L < n:
            counts = np.zeros(self.n_docs, dtype=np.int32)
        else:
            hit = self.tokens[:L - n + 1] == ids[0]
            for j in range(1, n):
                hit &= self.tokens[j:L - n + 1 + j] == ids[j]
            cum = np.concatenate(([0], np.cumsum(hit, dtype=np.int32)))
            last = np.maximum(f.ends - n + 1, f.starts)
            counts = cum[last] - cum[f.starts]
        if n == 1:
            # terms recur across queries; at most TF_CACHE arrays are kept
            if len(self._tf) >= TF_CACHE:
                self._tf.clear()
            self._tf[(f.name, toks)] = counts
        return counts

    def idf(self, doc_freq: int) -> np.float32:
        a = self.a
        n = np.float32(self.n_docs - doc_freq)
        x = a.div(a.add(n, np.float32(0.5)),
                  a.add(np.float32(doc_freq), np.float32(0.5)))
        return a.log1p(x)

    def _scored(self, sub, f: Field) -> tuple[np.ndarray, np.ndarray]:
        """(docs, scores) of a term or phrase clause in field `f`, docs
        ascending."""
        a = self.a
        terms = [sub[1]] if sub[0] == "term" else list(sub[1])
        freq = self._count(tuple(terms), f)
        idf = np.float32(0.0)
        for t in terms:
            df = int(np.count_nonzero(self._count((t,), f)))
            idf = a.add(idf, self.idf(max(df, 1)))
        weight = a.mul(idf, a.add(np.float32(1.0), np.float32(K1)))
        docs = np.flatnonzero(freq)
        tf = freq[docs].astype(np.float32)
        tf_factor = a.div(tf, a.add(tf, f.doc_norm[docs]))
        return docs, a.mul(weight, tf_factor)

    def _clause(self, sub) -> tuple[np.ndarray, np.ndarray]:
        """(docs, scores) of a term or phrase over the default fields: the
        sum in field order of the fields that match, from 0.0 (over one
        field, that field's own scores, as 0.0 + s == s in either
        precision)."""
        a = self.a
        hit = np.zeros(self.n_docs, dtype=bool)
        total = np.zeros(self.n_docs, dtype=np.float32)
        for f in self.fields:
            docs, s = self._scored(sub, f)
            hit[docs] = True
            dense = np.zeros(self.n_docs, dtype=np.float32)
            dense[docs] = s
            total = a.add(total, dense)
        docs = np.flatnonzero(hit)
        return docs, total[docs]

    def scores(self, query: str) -> tuple[np.ndarray, np.ndarray]:
        """(docs, scores) of every matching document, docs ascending."""
        q = parse(query)
        if q[0] != "bool":
            return self._clause(q)
        a = self.a
        must = should = None
        excluded = np.zeros(self.n_docs, dtype=bool)
        total = np.zeros(self.n_docs, dtype=np.float32)
        for occ, sub in q[1]:
            docs, s = self._clause(sub)
            hit = np.zeros(self.n_docs, dtype=bool)
            hit[docs] = True
            if occ == "must_not":
                excluded |= hit
                continue
            if occ == "must":
                must = hit if must is None else must & hit
            else:
                should = hit if should is None else should | hit
            # a clause that does not match adds an exact 0.0
            dense = np.zeros(self.n_docs, dtype=np.float32)
            dense[docs] = s
            total = a.add(total, dense)
        match = must if must is not None else should
        if match is None:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        docs = np.flatnonzero(match & ~excluded)
        return docs, total[docs]

    def topk(self, query: str, k: int) -> list[tuple[int, int, int]]:
        docs, sc = self.scores(query)
        if len(docs) > k:
            kth = np.partition(sc, len(sc) - k)[len(sc) - k]
            keep = sc >= kth
            docs, sc = docs[keep], sc[keep]
        order = np.lexsort((docs, -sc))[:k]
        seg, doc = self.c.address(docs[order])
        bits = sc[order].view(np.int32)
        return list(zip(bits.tolist(), seg.tolist(), doc.tolist()))
