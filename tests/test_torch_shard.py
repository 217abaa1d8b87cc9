"""The port's segment-sharded search (`parallel/shard.py`) with 8 shards on
the CPU against the port's single executor, the reference's
`ShardedSearcher` on its 8 virtual CPU devices and the host engine: the
same DocAddresses in the same order with f32 score bits equal
(`test_sharded_search.py`'s cases). A merge case holds ties across shards
to global DocAddress order."""

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu_torch as pt
from tantivy_tpu.parallel.shard import ShardedSearcher as JaxSharded
from tantivy_tpu.parallel.shard import default_mesh
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.parallel.shard import ShardedSearcher, merge_candidates

from test_device_ops import build_random_index
from test_torch_host_parity import bits, port_searcher, to_port
import zstd_stub

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def sharded_setup():
    index, words = build_random_index(num_docs=600, vocab=30, num_commits=6)
    searcher = index.reader().searcher()
    assert len(searcher.segment_readers()) == 6
    return searcher, port_searcher(index), words


def check(ref, port, queries, got, want_ref, k=10):
    """Sharded port hits == the port's single executor == the reference's
    sharded hits == the host engine, in f32 bits."""
    single = BatchExecutor(port, device="cpu", fused=False).search_batch(
        to_port(queries), k)
    assert len(got) == len(queries)
    for q, g, s, r in zip(queries, got, single, want_ref):
        assert bits(g) == bits(s), repr(q)
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(ref.search(q, tt.TopDocs(k))), repr(q)


def t(w):
    return tt.TermQuery(tt.Term.from_field_text("body", w))


def test_sharded_matches_host(sharded_setup):
    ref, port, words = sharded_setup
    terms = [tt.Term.from_field_text("body", w) for w in words]
    sharded = ShardedSearcher(port, CPU8, fused=False)
    assert sum(ex is not None for ex in sharded._execs) == 6
    got = sharded.search_term_batch(to_port(terms), k=10)
    want = JaxSharded(ref, default_mesh()).search_term_batch(terms, k=10)
    check(ref, port, [tt.TermQuery(x) for x in terms], got, want)


def test_sharded_boolean_matches_host(sharded_setup):
    ref, port, words = sharded_setup
    queries = [
        tt.BooleanQuery.union([t(words[0]), t(words[1])]),
        tt.BooleanQuery.intersection([t(words[2]), t(words[3])]),
        tt.BooleanQuery([
            (tt.Occur.MUST, t(words[4])),
            (tt.Occur.SHOULD, t(words[5])),
            (tt.Occur.MUST_NOT, t(words[6])),
        ]),
        tt.BooleanQuery(
            [(tt.Occur.SHOULD, t(words[i])) for i in (7, 8, 9)],
            minimum_number_should_match=2,
        ),
        tt.BooleanQuery.union([t(words[0]), t("zzz_missing")]),
        tt.BooleanQuery.intersection([t(words[0]), t("zzz_missing")]),
    ]
    got = ShardedSearcher(port, CPU8, fused=False).search_boolean_batch(
        to_port(queries), k=10)
    want = JaxSharded(ref, default_mesh()).search_boolean_batch(queries, 10)
    check(ref, port, queries, got, want)


def test_sharded_with_deletes():
    index, words = build_random_index(num_docs=300, vocab=20, num_commits=4)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[1]))
    w.commit()
    w.close()
    ref = index.reader().searcher()
    port = port_searcher(index)
    terms = [tt.Term.from_field_text("body", w_) for w_ in words[:6]]
    got = ShardedSearcher(port, CPU8, fused=False).search_term_batch(
        to_port(terms), 10)
    want = JaxSharded(ref, default_mesh()).search_term_batch(terms, 10)
    check(ref, port, [tt.TermQuery(x) for x in terms], got, want)


def test_sharded_boolean_prunes():
    """Two-phase WAND per shard: phase-1 + phase-2 shipped blocks are
    fewer than the candidates, hits exact."""
    index, words = build_random_index(num_docs=4000, vocab=12, num_commits=2)
    ref = index.reader().searcher()
    port = port_searcher(index)
    queries = [
        tt.BooleanQuery.union([t(words[i]), t(words[i + 1])])
        for i in range(0, 10, 2)
    ]
    sharded = ShardedSearcher(port, CPU8, fused=False)
    got = sharded.search_boolean_batch(to_port(queries), k=3)
    want = JaxSharded(ref, default_mesh()).search_boolean_batch(queries, 3)
    check(ref, port, queries, got, want, k=3)
    ls = sharded.last_shipped
    assert ls["phase1"] + ls["phase2"] < ls["candidates"], ls


def test_sharded_phrase_matches_host(sharded_setup):
    ref, port, words = sharded_setup
    rng = np.random.default_rng(5)
    pairs = [(words[i], words[j]) for i in range(6) for j in range(6)
             if i != j]
    rng.shuffle(pairs)
    queries = [tt.PhraseQuery("body", [a, b]) for a, b in pairs[:12]]
    got = ShardedSearcher(port, CPU8, fused=False).search_phrase_batch(
        to_port(queries), k=10)
    want = JaxSharded(ref, default_mesh()).search_phrase_batch(queries, 10)
    check(ref, port, queries, got, want)
    assert sum(bool(g) for g in got) >= 3  # the corpus holds phrase matches


def test_ties_across_shards_merge_in_address_order():
    """Four segments of the same documents: every doc of a term ties with
    its copies in the other segments, so the merge must order the tied
    hits by global (segment, doc), as the single executor and the host
    engine do."""
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for _ in range(4):
        for i in range(40):
            w.add_document(pt.Document(body=f"x{i % 5} y{i % 3}"))
        w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert len(searcher.segment_readers()) == 4
    queries = [pt.TermQuery(pt.Term.from_field_text("body", "x1")),
               pt.BooleanQuery.union([
                   pt.TermQuery(pt.Term.from_field_text("body", "x2")),
                   pt.TermQuery(pt.Term.from_field_text("body", "y0"))])]
    k = 30
    single = BatchExecutor(searcher, device="cpu").search_batch(queries, k)
    for n in (2, 3, 4):
        got = ShardedSearcher(searcher, ["cpu"] * n).search_batch(queries, k)
        for q, g, s in zip(queries, got, single):
            assert bits(g) == bits(s) == bits(
                searcher.search(q, pt.TopDocs(k))), (n, q)
            scores = [sc for sc, _ in g]
            assert len(set(scores)) < len(scores)  # ties cross shards
            assert len({a.segment_ord for _, a in g}) > 1


def test_merge_candidates_order():
    """The merge alone: ties by (segment, doc), -inf fill last, k cut."""
    sc = np.array([[[2.0, 1.0, -np.inf]], [[2.0, 1.0, 1.0]]], np.float32)
    sg = np.array([[[3, 3, 0]], [[1, 2, 1]]], np.int64)
    dc = np.array([[[9, 4, 0]], [[7, 5, 2]]], np.int64)
    msc, msg, mdc = merge_candidates(sc, sg, dc, 5, "cpu")
    assert msc.tolist() == [[2.0, 2.0, 1.0, 1.0, 1.0]]
    assert list(zip(msg[0], mdc[0])) == [(1, 7), (3, 9), (1, 2), (2, 5),
                                         (3, 4)]


@pytest.mark.cuda
def test_two_shards_on_one_card_match_single_executor(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zstd_stub.use(monkeypatch)
    index, words = build_random_index(num_docs=600, vocab=30, num_commits=6)
    port = port_searcher(index)
    queries = [pt.TermQuery(pt.Term.from_field_text("body", w))
               for w in words]
    queries += [pt.PhraseQuery("body", [words[i], words[i + 1]])
                for i in range(8)]
    want = BatchExecutor(port, device="cuda").search_batch(queries, 10)
    got = ShardedSearcher(port, ["cuda:0", "cuda:0"]).search_batch(
        queries, 10)
    assert [bits(g) for g in got] == [bits(w) for w in want]
