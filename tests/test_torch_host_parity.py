"""The port's host layers (its own copies of the reference's schema,
indexer, directory, termdict, postings, query, collector, aggregation and
searcher) against the reference's, on the reference's fixture indexes
opened by both packages from the same bytes: `searcher.search` must give
the same DocAddresses in the same order with the same f32 score bits, the
same counts and the same aggregation. One case runs the other way: an index
the port writes, read by the reference.

This module also holds the helpers the other `test_torch_*` modules use to
run the port on a reference fixture: `open_copy` copies an index's files
byte for byte into a `RamDirectory` of the other package and opens it
there (segment ids are random, so building the same documents twice could
order the segments differently; a copy keeps them), `port_searcher` does
that for the port, `to_port` rebuilds a reference query (or any object of
the reference's classes) from the port's classes, and `bits` puts hits of
either package in one comparable form."""

import enum
import importlib
import json

import numpy as np
import pytest

import tantivy_tpu as tt
import tantivy_tpu_torch as pt

from test_agg_random_golden import _build as build_fast_index
from test_device_phrase import build_phrase_index, sample_phrases


def open_copy(index, pkg):
    """`index`'s files, byte for byte, in a new RamDirectory of package
    `pkg` (`tantivy_tpu` or `tantivy_tpu_torch`), opened with pkg's
    `Index`."""
    directory = importlib.import_module(pkg.__name__ + ".directory")
    segment = importlib.import_module(pkg.__name__ + ".index.segment")
    src = index.directory.inner
    dst = directory.RamDirectory()
    for path in src.list_files():
        dst.write(path, src.open_read(path))
    managed = directory.ManagedDirectory(dst)
    meta = segment.IndexMeta.from_json(json.loads(
        managed.atomic_read(directory.META_FILEPATH).decode("utf-8")
    ))
    return pkg.Index(managed, pkg.Schema.from_json(meta.schema_json),
                     settings=pkg.IndexSettings.from_json(meta.settings))


def port_searcher(ref):
    """A port searcher over a copy of a reference index (or of the index
    behind a reference searcher) as it was last committed."""
    index = ref.index if isinstance(ref, tt.Searcher) else ref
    return open_copy(index, pt).reader().searcher()


def to_port(obj):
    """`obj` with every object of a reference class rebuilt as an object of
    the port's class of the same module path and name, attribute for
    attribute (enums by member name); lists, tuples and dicts are walked."""
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    mod = type(obj).__module__
    if not mod.startswith("tantivy_tpu."):
        return obj
    port_mod = importlib.import_module("tantivy_tpu_torch" + mod[11:])
    cls = getattr(port_mod, type(obj).__qualname__)
    if isinstance(obj, enum.Enum):
        return cls[obj.name]
    out = cls.__new__(cls)
    for name, value in vars(obj).items():
        object.__setattr__(out, name, to_port(value))
    return out


def bits(hits):
    """(score as int32 bits, (segment ord, doc id)) per hit, for hits of
    either package."""
    return [(int(np.float32(s).view(np.int32)), (a.segment_ord, a.doc_id))
            for s, a in hits]


@pytest.fixture(scope="module")
def phrase_corpus():
    index, words, texts = build_phrase_index()
    return (index.reader().searcher(), port_searcher(index), words, texts)


@pytest.fixture(scope="module")
def fast_corpus():
    """Three segments with u64, f64 and multi-valued fast fields and
    deletes (no merge: the default policy merges from eight segments)."""
    index, _ = build_fast_index(np.random.default_rng(4), 420, 3, 0.1)
    return index.reader().searcher(), port_searcher(index)


def _term(pkg, field, text):
    return pkg.TermQuery(pkg.Term.from_field_text(field, text))


#: query kind -> (corpus, builder(pkg, words, texts))
KINDS = {
    "term": ("phrase", lambda p, w, x: _term(p, "body", w[3])),
    "boolean_must_not": ("phrase", lambda p, w, x: p.BooleanQuery([
        (p.Occur.MUST, _term(p, "body", w[0])),
        (p.Occur.SHOULD, _term(p, "body", w[5])),
        (p.Occur.MUST_NOT, _term(p, "body", w[1])),
    ])),
    "phrase": ("phrase", lambda p, w, x: p.PhraseQuery(
        "body", sample_phrases(np.random.default_rng(1), x, 1, 3)[0])),
    "sloppy_phrase": ("phrase", lambda p, w, x: p.PhraseQuery(
        "body", [w[2], w[4]], slop=2)),
    "phrase_prefix": ("phrase", lambda p, w, x: p.PhrasePrefixQuery(
        "body", [w[6], "w1"])),
    "range": ("fast", lambda p, w, x: p.RangeQuery("full_u", 3, 8)),
    "fuzzy": ("phrase", lambda p, w, x: p.FuzzyTermQuery(
        p.Term.from_field_text("body", "w17"), distance=1)),
    "regex": ("phrase", lambda p, w, x: p.RegexQuery("w1[0-4]", "body")),
    "all": ("fast", lambda p, w, x: p.AllQuery()),
    "exists": ("fast", lambda p, w, x: p.ExistsQuery("opt_f")),
}


def _pair(kind, phrase_corpus, fast_corpus):
    """(reference searcher, port searcher, reference query, port query)."""
    corpus, make = KINDS[kind]
    if corpus == "phrase":
        ref, port, words, texts = phrase_corpus
    else:
        (ref, port), words, texts = fast_corpus, None, None
    return (ref, port, make(tt, words, texts), make(pt, words, texts))


@pytest.mark.parametrize("kind", list(KINDS))
def test_search_matches_reference(phrase_corpus, fast_corpus, kind):
    ref, port, q_ref, q_port = _pair(kind, phrase_corpus, fast_corpus)
    for k in (1, 10, 50):
        want = ref.search(q_ref, tt.TopDocs(k))
        got = port.search(q_port, pt.TopDocs(k))
        assert bits(got) == bits(want), (kind, k)
    assert want, f"{kind} matches nothing: the case would prove little"


@pytest.mark.parametrize("kind", list(KINDS))
def test_count_matches_reference(phrase_corpus, fast_corpus, kind):
    ref, port, q_ref, q_port = _pair(kind, phrase_corpus, fast_corpus)
    assert port.search(q_port, pt.Count()) == ref.search(q_ref, tt.Count())


def test_aggregation_matches_reference(fast_corpus):
    ref, port = fast_corpus
    req = {
        "by_cat": {
            "terms": {"field": "cat", "size": 100},
            "aggs": {"s": {"stats": {"field": "full_u"}},
                     "o": {"avg": {"field": "opt_f"}}},
        },
        "hist": {
            "histogram": {"field": "full_u", "interval": 3.0},
            "aggs": {"m": {"sum": {"field": "multi_u"}}},
        },
    }
    want = ref.search(tt.RangeQuery("full_u", 2, 10),
                      tt.AggregationCollector(req))
    got = port.search(pt.RangeQuery("full_u", 2, 10),
                      pt.AggregationCollector(req))
    assert want["by_cat"]["buckets"], "the aggregation is empty"
    assert got == want


def test_reference_reads_port_built_index():
    """The other direction: an index the port writes (two segments, a
    delete, a fast field), copied into the reference and searched by both."""
    rng = np.random.default_rng(21)
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    b.add_u64_field("n", pt.FAST)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    words = [f"w{i}" for i in range(20)]
    for c in range(2):
        for i in range(150):
            w.add_document(pt.Document(
                body=" ".join(rng.choice(words, int(rng.integers(3, 20)))),
                n=int(rng.integers(0, 50)),
            ))
        w.commit()
    w.delete_term(pt.Term.from_field_text("body", words[7]))
    w.commit()
    w.close()
    port = index.reader().searcher()
    ref = open_copy(index, tt).reader().searcher()
    assert [r.max_doc for r in ref.segment_readers()] == [
        r.max_doc for r in port.segment_readers()]
    for make in (
        lambda p: _term(p, "body", words[1]),
        lambda p: p.BooleanQuery.intersection(
            [_term(p, "body", words[0]), _term(p, "body", words[2])]),
        lambda p: p.PhraseQuery("body", [words[0], words[1]]),
        lambda p: p.RangeQuery("n", 10, 20),
    ):
        want = ref.search(make(tt), tt.TopDocs(20))
        assert want
        assert bits(port.search(make(pt), pt.TopDocs(20))) == bits(want)
    assert port.search(pt.AllQuery(), pt.Count()) == ref.search(
        tt.AllQuery(), tt.Count())
