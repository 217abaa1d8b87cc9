"""The corpus generator: a Zipf token stream over a fixed vocabulary,
windowed into documents, all drawn from the run's seed.

After `chip_smoke.py` (`token_stream`, `corpus`), driven by a
configuration's `corpus` parameters, with the seed setting the order of
fixed word counts and fixed document lengths rather than drawing them
(or, where the configuration says so, the order of the words alone), so
that every seed indexes as much text of the same shape. Both sides of the benchmark read it:
the program indexes each document's text, and the reference reads the
same windows as (start, end) offsets into the stream.

A configuration names its text fields with `field` (one name) or
`fields` (several, in the query parser's default-field order; see
`spec.py`). The field without a `doc_len` of its own, the main field,
takes the corpus's `doc_len` and the windows above. Each other field's
window has a length drawn from its own `doc_len` and starts at a seeded
offset into the main field's window, so that it lies inside that window
where it fits (a title's words occur in its body), cut at the stream's
end. Those draws use purposes of `rng_for` that no other draw uses, so the
main field's stream, lengths and starts are those of a one-field
configuration, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: a pass over the stream starts this many tokens after the last pass's
#: start (the smoke's shifting start)
PASS_SHIFT = 131
#: no document starts within this many tokens of the stream's end
TAIL_GAP = 10
#: a pass starts no later than this many tokens before the stream's end
PASS_ROOM = 200
#: `rng_for` purposes of a further field's lengths and of its offsets into
#: the main field's windows (the field's place in `fields` is the index)
FIELD_LENGTHS = 20
FIELD_OFFSETS = 21


@dataclass
class Corpus:
    """`fields` gives every text field's name and (starts, ends), in the
    parser's default-field order: `words[stream[starts[d]:ends[d]]]`,
    joined by spaces, is document d's text in that field. Documents are
    committed in order, `per_segment` a commit."""

    words: np.ndarray
    stream: np.ndarray
    per_segment: int
    fields: dict[str, tuple[np.ndarray, np.ndarray]]

    @property
    def n_docs(self) -> int:
        return len(next(iter(self.fields.values()))[0])

    def texts(self, field: str):
        """Each document's text in `field`, in commit order."""
        starts, ends = self.fields[field]
        toks = self.words[self.stream].tolist()
        for s, e in zip(starts.tolist(), ends.tolist()):
            yield " ".join(toks[s:e])

    def documents(self):
        """Each document as {field: text}, in commit order."""
        names = list(self.fields)
        for texts in zip(*(self.texts(f) for f in names)):
            yield dict(zip(names, texts))

    def address(self, doc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(segment, doc id) of global document numbers under the commit
        schedule."""
        doc = np.asarray(doc, dtype=np.int64)
        return doc // self.per_segment, doc % self.per_segment


def rng_for(seed: int, purpose: int, index: int = 0):
    """A generator of its own for each (seed, purpose, index); any whole
    seed, negative or past 64 bits, is taken."""
    return np.random.default_rng([purpose, index, seed % (1 << 64)])


def token_stream(seed: int, vocab: int, n_tokens: int):
    """(words, stream): `n_tokens` word ids over `vocab` words named `w0`,
    `w1`, ... with Zipf(1) frequencies (the smoke's stand-in for a real
    text). Each word occurs its expected number of times, the remainders
    going to the largest fractions, so that every seed has the same
    counts; the seed sets their order."""
    probs = 1.0 / np.arange(1, vocab + 1)
    expected = n_tokens * probs / probs.sum()
    counts = np.floor(expected).astype(np.int64)
    short = n_tokens - int(counts.sum())
    counts[np.argsort(counts - expected, kind="stable")[:short]] += 1
    stream = np.repeat(np.arange(vocab, dtype=np.int32), counts)
    rng_for(seed, 0).shuffle(stream)
    words = np.array([f"w{i}" for i in range(vocab)])
    return words, stream


def doc_lengths(rng, n_docs: int, spec: dict) -> np.ndarray:
    """Each document's length in tokens: `uniform` over [lo, hi) or
    `loguniform` between lo and hi, taken at the midpoints of `n_docs`
    equal strata, so that every seed has the same lengths, in the order
    that `rng` gives."""
    lo, hi = spec["lo"], spec["hi"]
    u = (np.arange(n_docs) + 0.5) / n_docs
    if spec["dist"] == "uniform":
        lens = lo + np.floor(u * (hi - lo)).astype(np.int64)
    elif spec["dist"] == "loguniform":
        lens = np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
                       ).astype(np.int64)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return rng.permutation(lens)


def windows(n_tokens: int, lens: np.ndarray):
    """(starts, ends): consecutive windows over the stream, a pass at a
    time, each pass starting PASS_SHIFT tokens further in; a window that
    runs past the stream's end is cut there."""
    n_docs = len(lens)
    starts = np.empty(n_docs, dtype=np.int64)
    made = 0
    passno = 0
    lens_l = lens.tolist()
    while made < n_docs:
        i = (passno * PASS_SHIFT) % max(n_tokens - PASS_ROOM, 1)
        while i + TAIL_GAP < n_tokens and made < n_docs:
            starts[made] = i
            i += lens_l[made]
            made += 1
        passno += 1
    return starts, np.minimum(starts + lens, n_tokens)


def text_fields(cfg: dict) -> list[dict]:
    """A configuration's text fields, each {"name"[, "doc_len"]}, in the
    parser's default-field order: `fields`, or the one `field`. Exactly one
    of them has no `doc_len`."""
    fields = cfg.get("fields") or [{"name": cfg["field"]}]
    if sum("doc_len" not in f for f in fields) != 1:
        raise ValueError("exactly one field takes the corpus's doc_len")
    return fields


def _sized(spec: dict, seed: int, purpose: int, index: int, n_docs: int):
    """Lengths by `spec` (see `doc_lengths`), in the seed's order or, with
    `"order": "fixed"`, in seed 0's for every seed, so that each block of
    documents holds as many tokens in every run."""
    fixed = spec.get("order", "seed") == "fixed"
    return doc_lengths(rng_for(0 if fixed else seed, purpose, index),
                       n_docs, spec)


def make_corpus(spec: dict, seed: int, fields: list[dict]) -> Corpus:
    """The corpus a configuration's `corpus` parameters and text fields
    (`text_fields`) give for `seed`."""
    words, stream = token_stream(seed, spec["vocab"], spec["stream_tokens"])
    n_docs, n_tokens = spec["docs"], len(stream)
    lens = _sized(spec["doc_len"], seed, 1, 0, n_docs)
    starts, ends = windows(n_tokens, lens)
    spans = {}
    for j, f in enumerate(fields):
        if "doc_len" not in f:
            spans[f["name"]] = (starts, ends)
            continue
        n = _sized(f["doc_len"], seed, FIELD_LENGTHS, j, n_docs)
        room = np.maximum(ends - starts - n, 0)
        u = rng_for(seed, FIELD_OFFSETS, j).random(n_docs)
        s = starts + np.floor(u * (room + 1)).astype(np.int64)
        spans[f["name"]] = (s, np.minimum(s + n, n_tokens))
    per = -(-n_docs // spec["segments"])
    return Corpus(words, stream, per, spans)
