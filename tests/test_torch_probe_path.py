"""The port's per-segment Block-WAND boolean path,
`BatchExecutor.search_boolean_batch` on device="cpu" (kernel K3's twin and
the deep per-lane probe), against the reference's `search_boolean_batch`
(its XLA per-segment path on the CPU, and once its own Pallas K3 in
interpret mode) and the host engine. The port reads each index from a byte
copy with its own searcher and query classes. Hits must be equal: the same
DocAddresses in the same order, with f32 score bits equal."""

import numpy as np
import pytest

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import pallas_probe as pp
from tantivy_tpu.ops import probe_scorer as ref_ps
from tantivy_tpu_torch import BatchExecutor

from test_device_ops import build_random_index
from test_probe_wand import random_bool_query
from test_torch_host_parity import bits, port_searcher, to_port


def t(w, field="body"):
    return tt.TermQuery(tt.Term.from_field_text(field, w))


def check(searcher, queries, k=10):
    """Port hits == reference hits == host hits; returns the port's
    executor (its launch log on) for counter checks."""
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_boolean_batch(to_port(queries), k)
    ref = jax_par.BatchExecutor(searcher).search_boolean_batch(queries, k)
    assert len(got) == len(ref) == len(queries)
    for q, g, r in zip(queries, got, ref):
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(k))), repr(q)
    return port


@pytest.fixture(scope="module")
def wide_index():
    return build_wide_index()


def build_wide_index():
    """One segment where a rare term's blocks span a dense partner: `a` is
    in every doc (71 blocks), `h` in every third (24 blocks), `m` in every
    tenth, `r` in ten docs, plus a sprinkle of `z*` terms; one word is
    deleted from some docs by deleting the docs holding `z7`."""
    rng = np.random.default_rng(0)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_text_field("title", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for i in range(9000):
        toks = ["a"] * int(rng.integers(1, 4))
        if i % 3 == 0:
            toks.append("h")
        if i % 10 == 0:
            toks.append("m")
        if i % 997 == 5:
            toks.append("r")
        if rng.random() < 0.3:
            toks.append(f"z{int(rng.integers(0, 20))}")
        title = "r" if i % 5 == 0 else "q"
        w.add_document(tt.Document(body=" ".join(toks), title=title))
    w.commit()
    w.delete_term(tt.Term.from_field_text("body", "z7"))
    w.commit()
    w.close()
    return index.reader().searcher()


def test_wide_windows_reach_kw64_and_the_deep_path(wide_index):
    queries = [
        tt.BooleanQuery.intersection([t("r"), t("a")]),
        tt.BooleanQuery.intersection([t("r"), t("h")]),
        tt.BooleanQuery.union([t("a"), t("m")]),
        tt.BooleanQuery.union([t("a")]),
        tt.BooleanQuery.union([t("r"), t("z3")]),
        tt.BooleanQuery([(tt.Occur.MUST, t("h")),
                         (tt.Occur.MUST_NOT, t("m"))]),
        tt.BooleanQuery([(tt.Occur.SHOULD, t(x)) for x in ("r", "m", "h")],
                        minimum_number_should_match=2),
    ]
    assert any(r.has_deletes() for r in wide_index.segment_readers())
    port = check(wide_index, queries)
    for rung in ("probe_kw2", "probe_kw8", "probe_kw64", "probe_deep"):
        assert port.plan_stats.get(rung, 0) > 0, (rung, port.plan_stats)
    log = [rec for rec in port.launch_log if rec["kind"] == "probe"]
    assert {rec["kw"] for rec in log} == {2, 8, 64}
    assert {rec["phase"] for rec in log} == {1, 2}
    # K4's chunks are logged once per deep launch
    deep = [rec for rec in port.launch_log if rec["kind"] == "deep"]
    assert len(deep) == port.plan_stats["probe_deep"]
    assert len(log) + len(deep) == len(port.launch_log)


@pytest.mark.parametrize("seed", [1, 2])
def test_random_boolean_queries(seed):
    rng = np.random.default_rng(seed)
    index, words = build_random_index(num_docs=600, vocab=40, num_commits=2,
                                      seed=seed)
    searcher = index.reader().searcher()
    queries = [random_bool_query(rng, words) for _ in range(40)]
    check(searcher, queries, k=int(rng.integers(1, 12)))


def test_deletes_and_a_missing_must_term():
    rng = np.random.default_rng(7)
    index, words = build_random_index(num_docs=400, vocab=30, num_commits=2,
                                      seed=7)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[2]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert any(r.has_deletes() for r in searcher.segment_readers())
    queries = [random_bool_query(rng, words) for _ in range(20)]
    queries += [
        tt.BooleanQuery.intersection([t(words[0]), t("absent")]),
        tt.BooleanQuery([(tt.Occur.SHOULD, t("absent")),
                         (tt.Occur.SHOULD, t(words[1]))]),
        tt.BooleanQuery([(tt.Occur.MUST, t(words[2])),
                         (tt.Occur.SHOULD, t(words[3]))]),
    ]
    port = check(searcher, queries, k=5)
    assert port.search_boolean_batch([], 5) == []


def test_multi_field_query_runs_the_fused_chain(wide_index, monkeypatch):
    """The per-segment planner is single-field: a query across fields runs
    the fused chain (kernel K1) inside the same call, with the hits of the
    reference's fused chain (Pallas, interpret mode)."""
    queries = [
        tt.BooleanQuery.union([t("r", "body"), t("r", "title")]),
        tt.BooleanQuery.intersection([t("h"), t("m")]),
        tt.BooleanQuery([(tt.Occur.MUST, t("m", "body")),
                         (tt.Occur.MUST_NOT, t("r", "title"))]),
    ]
    port = BatchExecutor(port_searcher(wide_index), device="cpu",
                         fused=False)
    port.launch_log = []
    got = port.search_boolean_batch(to_port(queries), 10)
    kinds = {rec["kind"] for rec in port.launch_log}
    assert kinds == {"bool", "probe"}
    monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")
    ref = jax_par.BatchExecutor(wide_index).search_batch(queries, 10)
    for q, g, r in zip(queries, got, ref):
        assert bits(g) == bits(r), repr(q)
    for q, g in zip(queries[1:], got[1:]):
        assert bits(g) == bits(wide_index.search(q, tt.TopDocs(10)))
    # a fault of the fused chain in both packages: a clause on another
    # field is scored with the lane's own field norm, so doc 5 (body and
    # title both hold `r`, with different field lengths) scores
    # 0x40e113bc instead of the host engine's 0x40e9433e
    doc5 = (0, 5)
    host = wide_index.search(queries[0], tt.TopDocs(10))
    assert dict((a, s) for s, a in bits(got[0]))[doc5] == 0x40E113BC
    assert dict((a, s) for s, a in bits(host))[doc5] == 0x40E9433E
    with pytest.raises(ValueError):
        port.search_boolean_batch([to_port(t("h"))], 10)


def test_reference_pallas_k3_agrees(monkeypatch):
    """The reference's `search_boolean_batch` with its own K3 (Pallas,
    interpret mode): `_pallas_mode` answers None to the entry point's
    check, which keeps the per-segment path, and "interpret" afterwards,
    which sends `dispatch_probe` to `pallas_bool_topk`."""
    answers = iter([None])
    monkeypatch.setattr(ref_ps, "_pallas_mode",
                        lambda: next(answers, "interpret"))
    k3_calls = []

    def counted(*args, **kwargs):
        k3_calls.append(kwargs["kw"])
        return k3(*args, **kwargs)

    k3 = pp.pallas_bool_topk
    monkeypatch.setattr(pp, "pallas_bool_topk", counted)
    rng = np.random.default_rng(11)
    index, words = build_random_index(num_docs=600, vocab=40, num_commits=2,
                                      seed=11)
    searcher = index.reader().searcher()
    queries = [random_bool_query(rng, words) for _ in range(12)]
    ref = jax_par.BatchExecutor(searcher).search_boolean_batch(queries, 10)
    assert k3_calls, "the reference did not reach its Pallas K3"
    got = BatchExecutor(port_searcher(searcher), device="cpu",
                        fused=False).search_boolean_batch(to_port(queries),
                                                          10)
    for q, g, r in zip(queries, got, ref):
        assert bits(g) == bits(r), repr(q)
