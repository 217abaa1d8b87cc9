"""The port's counterpart of `tests/test_mixed_batch.py`: `search_batch` over
a mixed query inventory, device-eligible kinds (term, boolean, phrase,
phrase-prefix) interleaved with host-tail kinds (sloppy phrase, fuzzy,
regex, term-set, dismax, boosted term, MUST_NOT boolean, all), on the
reference's corpus read from a byte copy. Each test runs the route of the
reference mode its JAX twin uses and compares with the reference in that
mode: parity, order stability and pipelined parity on `fused=False`
against the reference's XLA mode; dismax expansion, prefix truncation and
row-budget sub-batching on `fused=True` against its Pallas mode in
interpret mode. Parity and order stability also run on both routes
against the host engine. Hits must be equal: the same DocAddresses in the
same order, with f32 score bits equal."""

import numpy as np
import pytest

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import probe_scorer as ref_ps
from tantivy_tpu.query import (
    BoostQuery,
    DisjunctionMaxQuery,
    TermQuery,
    TermSetQuery,
)
from tantivy_tpu.query.automaton_queries import FuzzyTermQuery, RegexQuery
from tantivy_tpu.query.phrase_query import PhrasePrefixQuery, PhraseQuery
from tantivy_tpu_torch import BatchExecutor

from test_mixed_batch import build_corpus
from test_torch_host_parity import bits, port_searcher, to_port


def t(word):
    return TermQuery(tt.Term.from_field_text("body", word))


@pytest.fixture
def xla_mode(monkeypatch):
    monkeypatch.delenv("TANTIVY_TPU_PALLAS", raising=False)
    assert ref_ps._pallas_mode() is None


@pytest.fixture
def pallas_mode(monkeypatch):
    monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")
    assert ref_ps._pallas_mode() == "interpret"


def check(searcher, queries, got, k, ref=None):
    """Port hits == the host engine's (and the reference's, when given)."""
    assert len(got) == len(queries)
    for i, (q, g) in enumerate(zip(queries, got)):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(k))), repr(q)
        if ref is not None:
            assert bits(g) == bits(ref[i]), repr(q)


def reference(searcher, queries, k, fused: bool, monkeypatch):
    """The reference's `search_batch` in the mode matching route `fused`."""
    if fused:
        monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")
    else:
        monkeypatch.delenv("TANTIVY_TPU_PALLAS", raising=False)
    assert (ref_ps._pallas_mode() is not None) == fused
    return jax_par.BatchExecutor(searcher).search_batch(queries, k)


@pytest.mark.parametrize("fused", [False, True])
def test_mixed_batch_parity(fused, monkeypatch):
    searcher = build_corpus().reader().searcher()
    queries = [
        t("w00"),
        tt.BooleanQuery.union([t("w01"), t("w02")]),
        PhraseQuery("body", ["w00", "w01"]),
        PhraseQuery("body", ["w01", "w03"], slop=2),          # host tail
        PhrasePrefixQuery("body", ["prefix"]),                 # expansion
        FuzzyTermQuery(tt.Term.from_field_text("body", "w01"), 1),
        RegexQuery("w0[0-3]", "body"),
        TermSetQuery([tt.Term.from_field_text("body", w)
                      for w in ("w04", "w05")]),
        DisjunctionMaxQuery([t("w02"), t("w06")], tie_breaker=0.3),
        BoostQuery(t("w07"), 2.0),
        tt.BooleanQuery([(tt.Occur.MUST, t("w00")),
                         (tt.Occur.MUST_NOT, t("w01"))]),
        tt.AllQuery(),
    ]
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=fused)
    got = ex.search_batch(to_port(queries), 10)
    check(searcher, queries, got, 10,
          reference(searcher, queries, 10, fused, monkeypatch))


@pytest.mark.parametrize("fused", [False, True])
def test_mixed_batch_order_stability(fused, monkeypatch):
    """Result list positions must match input positions even when the
    router reorders work internally (device groups, expansions, tail)."""
    searcher = build_corpus(seed=10).reader().searcher()
    # interleave kinds so sub-batches are non-contiguous
    queries = []
    for i in range(8):
        queries.append(t(f"w{i:02d}"))
        queries.append(PhraseQuery("body", [f"w{i:02d}", f"w{i + 1:02d}"]))
        queries.append(FuzzyTermQuery(
            tt.Term.from_field_text("body", f"w{i:02d}"), 1))
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=fused)
    got = ex.search_batch(to_port(queries), 5)
    check(searcher, queries, got, 5,
          reference(searcher, queries, 5, fused, monkeypatch))


def test_dismax_term_clauses_device_expansion(pallas_mode):
    """DisjunctionMax (tie_breaker 0) over term and boosted-term clauses
    expands on the fused route into per-clause device queries merged
    keep-max; a nonzero tie_breaker stays on the host engine."""
    searcher = build_corpus().reader().searcher()
    queries = [
        DisjunctionMaxQuery([t("w00"), BoostQuery(t("w03"), 2.0)]),
        DisjunctionMaxQuery([t("w01"), t("w02")], tie_breaker=0.3),
    ]
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=True)
    ex.launch_log = []
    got = ex.search_batch(to_port(queries), 10)
    check(searcher, queries, got, 10,
          jax_par.BatchExecutor(searcher).search_batch(queries, 10))
    assert {rec["kind"] for rec in ex.launch_log} == {"bool"}


def test_phrase_prefix_device_truncation_parity(pallas_mode):
    """Multi-term phrase-prefixes ride the fused phrase launch with
    per-segment capped expansion rows: exact against the host engine even
    where segments truncate different expansion sets, with no
    `phrase_prefix_trunc` host plans, at k = 10 and k = 3."""
    rng = np.random.default_rng(17)
    # pre00..pre19 share a prefix; segment composition varies so each
    # segment's first-max_expansions set differs
    words = ([f"pre{i:02d}" for i in range(20)]
             + [f"w{i:02d}" for i in range(10)])
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for c in range(3):
        pool = words if c == 0 else words[c * 6:] + words[:3]
        for _ in range(120):
            w.add_document(tt.Document(body=" ".join(rng.choice(pool, 6))))
        w.commit()
    w.close()
    searcher = index.reader().searcher()
    queries = [
        PhrasePrefixQuery("body", ["w00", "pre"], max_expansions=4),
        PhrasePrefixQuery("body", ["w01", "pre"], max_expansions=50),
        PhrasePrefixQuery("body", ["pre00", "pre"], max_expansions=3),
        PhrasePrefixQuery("body", ["w02", "pre0"]),
        PhrasePrefixQuery("body", ["w03", "zzz"]),  # no expansions
        PhraseQuery("body", ["w00", "w01"]),        # mixed in one launch
    ]
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=True)
    ref = jax_par.BatchExecutor(searcher)
    for k in (10, 3):
        got = ex.search_batch(to_port(queries), k)
        check(searcher, queries, got, k, ref.search_batch(queries, k))
    assert "phrase_prefix_trunc" not in ex.fallbacks
    assert ex.host_routed == 0


def test_phrase_prefix_row_budget_subbatching(pallas_mode, monkeypatch):
    """A prefix batch whose expansion rows exceed the plan-row tier
    sub-batches by row budget, not query count, and stays exact."""
    searcher = build_corpus(seed=11).reader().searcher()
    queries = [PhrasePrefixQuery("body", ["w00", "prefix"])
               for _ in range(6)]
    queries += [PhraseQuery("body", ["w01", "w02"])]
    want = jax_par.BatchExecutor(searcher).search_batch(queries, 5)
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=True)
    ex.launch_log = []
    # 8 plan rows a launch: the 6 prefixes (2 expansions x 3 segments
    # each) must split
    monkeypatch.setattr(BatchExecutor, "_prow_tier",
                        staticmethod(lambda n, Tb=2: 8))
    got = ex.search_batch(to_port(queries), 5)
    check(searcher, queries, got, 5, want)
    assert len(ex.launch_log) > 1


def test_search_batches_pipelined_parity(xla_mode):
    """The pipelined multi-batch API returns exactly what sequential calls
    return, in order, with a span per batch: two batches in flight share
    the executor's caches and the fused store."""
    searcher = build_corpus(seed=11).reader().searcher()
    batches = []
    for b in range(5):
        qs = []
        for i in range(6):
            w = f"w{(b * 6 + i) % 38:02d}"
            qs.append(t(w))
            qs.append(tt.BooleanQuery.union([t(w), t("w39")]))
            qs.append(PhraseQuery("body", [w, f"w{(b + i + 1) % 38:02d}"]))
        batches.append(qs)
    ref = jax_par.BatchExecutor(searcher)
    ref_hits = [ref.search_batch(b, 7) for b in batches]
    ex = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port_batches = to_port(batches)
    want = [ex.search_batch(b, 7) for b in port_batches]
    got = ex.search_batches(port_batches, 7, pipeline=2)
    assert got == want
    for qs, g, r in zip(batches, got, ref_hits):
        check(searcher, qs, g, 7, r)
    assert len(ex.batch_spans) == len(batches)
    assert all(s > 0 for s in ex.batch_spans)
    # degenerate pipelines
    assert ex.search_batches([], 7) == []
    assert ex.search_batches(port_batches[:1], 7, pipeline=4) == want[:1]
