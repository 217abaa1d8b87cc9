"""The reference against the port's plain versions at a tiny size, for
every query form of the benchmark's mixes, over one `body` field and over
a title + body index that the parser queries on both fields, and the
reference's own parts against tantivy's definitions.

These tests hold the benchmark (its generator, its reference and its
`correct` check) and hold the port only by its answers, never by its known
faults or its routing counters."""

import numpy as np
import pytest
from conftest import (
    TINY_CORPUS,
    TITLE_BODY,
    run_cell,
    small_mix,
    write_tiny_bench,
)

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

#: the text fields of each tiny index
LAYOUTS = {"body": [{"name": "body"}], "title+body": TITLE_BODY}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def tiny(request):
    """A tiny corpus indexed by the port, its searcher on the CPU, and
    the reference over the same corpus."""
    from searchbench.harness import build_index, zstd_codec

    zstd_codec()
    corpus = make_corpus(TINY_CORPUS, 2**31 + 7, LAYOUTS[request.param])
    index = build_index(corpus)
    return corpus, index, Reference(corpus)


def bits(hits):
    return [(int(np.float32(s).view(np.int32)), a.segment_ord, a.doc_id)
            for s, a in hits]


def port_topk(corpus, index, strings, k=10):
    """The port's answers on its default route (`search_batch`), its
    host engine's (`searcher.search`), and the executor; the parser's
    default fields are the corpus's text fields."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.parallel import BatchExecutor
    from tantivy_tpu_torch.query.parser import QueryParser

    searcher = index.reader().searcher()
    parser = QueryParser.for_index(index, list(corpus.fields))
    queries = [parser.parse_query(s) for s in strings]
    ex = BatchExecutor(searcher, device="cpu")
    got = [bits(h) for h in ex.search_batch(queries, k)]
    host = [bits(searcher.search(q, tt.TopDocs(k))) for q in queries]
    return got, host, ex


def known_departure(corpus, query: str) -> bool:
    """A lone term over several fields: the parser makes a boolean of term
    clauses across fields, which the port's default route sends to its
    fused chain, which scores every clause with one field's BM25
    denominator. That fault of the program is pinned in its own tests
    (`tests/test_torch_probe_path.py::
    test_multi_field_query_runs_the_fused_chain`), which the change that
    repairs the chain tightens. Here only the default route's answers to
    such a query are left out of the comparison; the benchmark still checks
    lone terms over two fields through a cell of them
    (`test_two_fields_lone_terms_are_checked`)."""
    return len(corpus.fields) > 1 and parse(query)[0] == "term"


def assert_port_equals(corpus, ref, index, strings, k=10):
    got, host, ex = port_topk(corpus, index, strings, k)
    want = [ref.topk(s, k) for s in strings]
    assert host == want
    for s, g, w in zip(strings, got, want):
        if not known_departure(corpus, s):
            assert g == w, s
    return got, want, ex


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
    _, want, ex = assert_port_equals(corpus, ref, index, strings)
    if list(corpus.fields) == ["body"]:
        # one field: every form runs on the device, so the tiny check
        # drives the device path; how queries across fields are routed is
        # the program's to choose
        assert not ex.fallbacks and ex.host_routed == 0
    assert sum(len(w) for w in want) > 0


@pytest.mark.parametrize("mix_name", ["questions", "phrase", "union"])
def test_reference_equals_port_on_real_mixes(tiny, mix_name):
    corpus, index, ref = tiny
    strings = Traffic(small_mix(mix_name, 40), corpus, 5).batch_at(3)
    assert_port_equals(corpus, ref, index, strings)


def test_reference_equals_port_on_repeated_terms(tiny):
    """Users repeat words; the generator does not, so these are by hand."""
    corpus, index, ref = tiny
    w = corpus.words
    strings = [f"{w[0]} {w[1]} {w[0]}", f"+{w[2]} +{w[2]}",
               f'"{w[0]} {w[0]}"', f"{w[3]} -{w[0]} {w[3]}"]
    assert_port_equals(corpus, ref, index, strings)


def test_reference_ranks_ties_by_address(tiny):
    corpus, index, ref = tiny
    # a rare word gives many equal scores among its documents
    strings = [str(corpus.words[-1]), str(corpus.words[300])]
    assert_port_equals(corpus, ref, index, strings, k=50)


@pytest.mark.parametrize("mix_name", ["questions", "union"])
def test_control_differs_from_reference(tiny, mix_name):
    corpus, _, ref = tiny
    low = Reference(corpus, Arith("bfloat16"))
    strings = Traffic(small_mix(mix_name, 20), corpus, 9).batch_at(0)
    assert all(low.topk(s, 10) != ref.topk(s, 10) for s in strings)


@pytest.fixture(scope="module")
def title_body():
    from searchbench.harness import build_index, zstd_codec

    zstd_codec()
    corpus = make_corpus(TINY_CORPUS, 2**31 + 7, TITLE_BODY)
    return corpus, build_index(corpus)


def test_two_fields_index_and_parse_as_tantivy(title_body):
    """Each field a TEXT field, in order; a bare term, a phrase and `+x`
    parse into SHOULD clauses over both fields, as tantivy's parser with
    two default fields makes them."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.query.parser import QueryParser

    corpus, index = title_body
    searcher = index.reader().searcher()
    assert searcher.num_docs() == corpus.n_docs
    parser = QueryParser.for_index(index, ["title", "body"])
    q = parser.parse_query("w1")
    assert isinstance(q, tt.BooleanQuery)
    assert [(o, sub.term.field) for o, sub in q.clauses] == [
        (tt.Occur.SHOULD, "title"), (tt.Occur.SHOULD, "body")]
    q = parser.parse_query('+w1 "w2 w3"')
    (o1, must), (o2, phrase) = q.clauses
    assert (o1, o2) == (tt.Occur.MUST, tt.Occur.SHOULD)
    assert [sub.term.field for _, sub in must.clauses] == ["title", "body"]
    assert [sub.field for _, sub in phrase.clauses] == ["title", "body"]
    assert [f.name for f in index.schema.fields()] == ["title", "body"]
    for name, (s, e) in corpus.fields.items():
        assert searcher.total_num_tokens(name) == int((e - s).sum())


@pytest.mark.parametrize("form", sorted(FORM_MIXES))
def test_two_fields_planted_denominator_fault_fails(title_body, form):
    """The fused chain's known fault, planted in the reference: the title's
    clauses scored with the body's BM25 denominator. The port's host
    engine then differs from it."""
    corpus, index = title_body
    ref = Reference(corpus)
    title, body = ref.fields
    title.doc_norm = body.doc_norm
    mix = {"batch": 30, "k": 10, "forms": [FORM_MIXES[form]]}
    strings = Traffic(mix, corpus, 11).batch_at(0)
    _, host, _ = port_topk(corpus, index, strings)
    assert host != [ref.topk(s, 10) for s in strings]


def host_engine_answers(monkeypatch):
    """A planted repair of the port's cross-field chain, as far as its
    answers go: the default route answers every query as the host engine
    does."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.parallel import BatchExecutor

    def search_batch(self, queries, k):
        return [self.searcher.search(q, tt.TopDocs(k)) for q in queries]

    monkeypatch.setattr(BatchExecutor, "search_batch", search_batch)


#: the port as it stands, and with its cross-field chain repaired
PROGRAMS = {"as_is": lambda monkeypatch: None,
            "planted_repair": host_engine_answers}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_two_fields_lone_terms_are_checked(title_body, tmp_path, monkeypatch,
                                           program):
    """Lone terms over two fields, which the parser makes booleans of term
    clauses across fields: the host engine answers them as the reference
    does, and a cell of them reads `correct` exactly when the port's default
    route answers the strings it compared as the reference does, whether
    that route is repaired or not."""
    from searchbench.harness import Run, build_index

    corpus, index = title_body
    ref = Reference(corpus)
    mix = {"batch": 30, "k": 10, "forms": [FORM_MIXES["term"]]}
    strings = Traffic(mix, corpus, 11).batch_at(0)
    _, host, _ = port_topk(corpus, index, strings)
    assert host == [ref.topk(s, 10) for s in strings]

    PROGRAMS[program](monkeypatch)
    write_tiny_bench(tmp_path, {"term": dict(mix, batch=24, check_sample=24)},
                     fields=TITLE_BODY)
    compared = {}
    real_check = Run.check

    def check(self, arith=None):
        compared["corpus"] = self.corpus
        compared["strings"] = [self.answers[i][0] for i in self.sample()]
        return real_check(self, arith)

    monkeypatch.setattr(Run, "check", check)
    rc, res, _ = run_cell(str(tmp_path), "tiny.term")
    assert rc == 0
    cell_corpus, cell_strings = compared["corpus"], compared["strings"]
    assert len(cell_strings) == res["checks"]["queries_compared"]["value"]
    assert len(cell_strings) == 24
    got, _, _ = port_topk(cell_corpus, build_index(cell_corpus),
                          cell_strings)
    cell_ref = Reference(cell_corpus)
    differing = sum(g != cell_ref.topk(s, 10)
                    for s, g in zip(cell_strings, got))
    assert res["correct"] is (differing == 0)
    assert (res["checks"]["hits_differing"]["value"] > 0) is (differing > 0)
    if program == "planted_repair":
        assert res["correct"] is True


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
