"""The reference against the port's plain versions at a tiny size, for
every query form of the benchmark's mixes, and the reference's own parts
against tantivy's definitions."""

import numpy as np
import pytest
from conftest import TINY_CORPUS, small_mix

from searchbench.corpus import make_corpus
from searchbench.reference import (
    FIELDNORMS,
    Arith,
    Reference,
    fieldnorm_id,
    parse,
    tokenize,
)
from searchbench.traffic import Traffic


@pytest.fixture(scope="module")
def tiny():
    """A tiny corpus indexed by the port, its searcher on the CPU, and
    the reference over the same corpus."""
    from searchbench.harness import build_index, zstd_codec

    zstd_codec()
    corpus = make_corpus(TINY_CORPUS, 2**31 + 7)
    index = build_index(corpus, "body")
    return corpus, index, Reference(corpus)


def port_topk(index, strings, k=10):
    from tantivy_tpu_torch.parallel import BatchExecutor
    from tantivy_tpu_torch.query.parser import QueryParser

    searcher = index.reader().searcher()
    parser = QueryParser.for_index(index, ["body"])
    ex = BatchExecutor(searcher, device="cpu")
    got = ex.search_batch([parser.parse_query(s) for s in strings], k)
    return [[(int(np.float32(s).view(np.int32)), a.segment_ord, a.doc_id)
             for s, a in hits] for hits in got], ex


FORM_MIXES = {
    "term": {"form": "term", "share": 1, "terms": [1]},
    "or": {"form": "or", "share": 1, "terms": [3, 4, 5, 6, 7, 8]},
    "and": {"form": "and", "share": 1, "terms": [2, 3]},
    "phrase2": {"form": "phrase", "share": 1, "terms": [2]},
    "phrase3": {"form": "phrase", "share": 1, "terms": [3]},
}


@pytest.mark.parametrize("form", sorted(FORM_MIXES))
def test_reference_equals_port(tiny, form):
    corpus, index, ref = tiny
    mix = {"batch": 30, "k": 10, "forms": [FORM_MIXES[form]]}
    strings = Traffic(mix, corpus, 11).batch_at(0)
    got, ex = port_topk(index, strings)
    want = [ref.topk(s, 10) for s in strings]
    assert got == want
    assert not ex.fallbacks and ex.host_routed == 0
    assert sum(len(w) for w in want) > 0


@pytest.mark.parametrize("mix_name", ["questions", "phrase"])
def test_reference_equals_port_on_real_mixes(tiny, mix_name):
    corpus, index, ref = tiny
    strings = Traffic(small_mix(mix_name, 40), corpus, 5).batch_at(3)
    got, _ = port_topk(index, strings, k=10)
    assert got == [ref.topk(s, 10) for s in strings]


def test_reference_equals_port_on_repeated_terms(tiny):
    """Users repeat words; the generator does not, so these are by hand."""
    corpus, index, ref = tiny
    w = corpus.words
    strings = [f"{w[0]} {w[1]} {w[0]}", f"+{w[2]} +{w[2]}",
               f'"{w[0]} {w[0]}"', f"{w[3]} -{w[0]} {w[3]}"]
    got, _ = port_topk(index, strings)
    assert got == [ref.topk(s, 10) for s in strings]


def test_reference_ranks_ties_by_address(tiny):
    corpus, index, ref = tiny
    # a rare word gives many equal scores among its documents
    strings = [str(corpus.words[-1]), str(corpus.words[300])]
    got, _ = port_topk(index, strings, k=50)
    assert got == [ref.topk(s, 50) for s in strings]


def test_control_differs_from_reference(tiny):
    corpus, _, ref = tiny
    low = Reference(corpus, Arith("bfloat16"))
    strings = Traffic(small_mix("questions", 20), corpus, 9).batch_at(0)
    assert all(low.topk(s, 10) != ref.topk(s, 10) for s in strings)


def test_fieldnorm_table_is_tantivys():
    assert FIELDNORMS[:41].tolist() == list(range(41))
    assert FIELDNORMS[41:50].tolist() == [42, 44, 46, 48, 50, 52, 54, 56,
                                          60]
    assert FIELDNORMS[255] == 2_013_265_944
    assert np.all(np.diff(FIELDNORMS) > 0)
    assert fieldnorm_id(np.array([0, 40, 41, 43, 59, 60, 3_000_000_000])
                        ).tolist() == [0, 40, 40, 41, 48, 49, 255]


def test_tokenizer_and_parser():
    assert tokenize("Hello, World-wide w1") == ["hello", "world", "wide",
                                               "w1"]
    assert tokenize("a" * 40 + " b" + "c" * 38) == ["b" + "c" * 38]
    assert parse("w1") == ("term", "w1")
    assert parse('"w1 W2"') == ("phrase", ["w1", "w2"])
    assert parse("+w1 +w2") == ("bool", [("must", ("term", "w1")),
                                         ("must", ("term", "w2"))])
    assert parse('w1 -w2 "w3 w4"') == (
        "bool", [("should", ("term", "w1")), ("must_not", ("term", "w2")),
                 ("should", ("phrase", ["w3", "w4"]))])


def test_bfloat16_rounds_to_nearest_even():
    a = Arith("bfloat16")
    assert a.r(np.float32(1.00390625)) == 1.0  # halfway: to the even 1.0
    assert a.r(np.float32(1.01171875)) == 1.015625  # halfway: up to even
    assert a.r(np.float32(1.005)) == 1.0078125
    assert Arith().r(np.float32(1.00390625)) == np.float32(1.00390625)
