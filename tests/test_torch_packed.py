"""Packed mode (`BatchExecutor(..., mode="packed")`) of the port on the CPU
against the reference's packed mode and the host engine: term batches
through the packed flat scorer (K5's twin) give the same DocAddresses in
the same order with f32 score bits equal; `search_batch` routes as the
reference's does with its fused chain off; the dense-only paths refuse;
`for_searcher` and `DeviceSearchWarmer` honour the mode; no host decode
and no fused store are made. The `cuda` case holds the card's packed term
batch to the CPU's."""

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu_torch as pt
from tantivy_tpu.parallel import BatchExecutor as JaxExecutor
from tantivy_tpu.parallel import DeviceSearchWarmer as JaxWarmer
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.parallel import DeviceSearchWarmer

from test_device_ops import build_random_index
from test_fused_bool import build_zipf_index
from test_torch_host_parity import bits, port_searcher, to_port
import zstd_stub


def check(searcher, terms, k=10, device="cpu"):
    """Port packed == reference packed == host `search_term_batch`, in f32
    bits; returns the port's executor."""
    ex = BatchExecutor(port_searcher(searcher), device=device, mode="packed")
    got = ex.search_term_batch(to_port(terms), k)
    want = JaxExecutor(searcher, mode="packed").search_term_batch(terms, k)
    assert len(got) == len(terms)
    for term, g, w in zip(terms, got, want):
        host = searcher.search(tt.TermQuery(term), tt.TopDocs(k))
        assert bits(g) == bits(w), term
        assert bits(g) == bits(host), term
    return ex


@pytest.mark.parametrize("k", [1, 10])
def test_random_fixture_three_commits(k):
    index, words = build_random_index(seed=5, num_commits=3)
    terms = [tt.Term.from_field_text("body", w) for w in words]
    terms.append(tt.Term.from_field_text("body", "absent"))
    ex = check(index.reader().searcher(), terms, k=k)
    assert ex.launch_log is None and ex._fused().cstore is None


def test_zipf_fixture_two_fields():
    """`body` and `title` terms in one batch: one launch per (segment,
    field) chunk, each over its own field's mirror."""
    index, words = build_zipf_index()
    terms = [tt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    ex = BatchExecutor(port_searcher(index), device="cpu", mode="packed")
    ex.launch_log = []
    ex.search_term_batch(to_port(terms), 10)
    fields = {id(rec["args"][0]) for rec in ex.launch_log}
    assert {rec["kind"] for rec in ex.launch_log} == {"packed_flat"}
    assert len(fields) == 2 * len(ex.searcher.segment_readers())
    check(index.reader().searcher(), terms)


def test_with_deletes_and_missing_term():
    index, words = build_random_index(num_commits=1)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[0]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert searcher.segment_readers()[0].has_deletes()
    terms = [tt.Term.from_field_text("body", w_) for w_ in words[:8]]
    check(searcher, terms + [tt.Term.from_field_text("body", "nope")])
    ex = BatchExecutor(port_searcher(index), device="cpu", mode="packed")
    assert ex.search_term_batch(
        [pt.Term.from_field_text("body", "nope")], 5) == [[]]
    assert ex.search_term_batch([], 5) == []


def test_two_phase_prunes():
    """Terms span many blocks per segment: phase 2 ships only the blocks
    that can beat the phase-1 threshold; hits stay exact."""
    index, words = build_random_index(num_docs=4000, vocab=12, num_commits=2)
    ex = check(index.reader().searcher(),
               [tt.Term.from_field_text("body", w) for w in words], k=3)
    st = ex.plan_stats
    assert st["wand_p1"] + st.get("wand_p2", 0) < st["wand_candidates"], st


def test_packed_hits_equal_dense_hits():
    index, words = build_zipf_index()
    port = port_searcher(index)
    terms = [pt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    dense = BatchExecutor(port, device="cpu").search_term_batch(terms, 10)
    packed = BatchExecutor(port, device="cpu",
                           mode="packed").search_term_batch(terms, 10)
    assert [bits(h) for h in packed] == [bits(h) for h in dense]


def mixed_index():
    """`body` and `title` text and a `score` fast field in three segments,
    one with deletes."""
    rng = np.random.default_rng(21)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_text_field("title", tt.TEXT)
    b.add_u64_field("score", tt.FAST)
    index = tt.Index.create_in_ram(b.build())
    words = [f"w{i:02d}" for i in range(30)] + ["prefixable", "prefixed"]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    w = index.writer_for_tests()
    for _ in range(3):
        for _ in range(150):
            w.add_document(tt.Document(
                body=" ".join(rng.choice(words, 9, p=p)),
                title=" ".join(rng.choice(words, 3, p=p)),
                score=int(rng.integers(0, 100))))
        w.commit()
    w.delete_term(tt.Term.from_field_text("title", "w03"))
    w.commit()
    w.close()
    return index


def _t(word, field="body"):
    return tt.TermQuery(tt.Term.from_field_text(field, word))


def test_search_batch_routes_as_the_reference():
    """A batch of term, range, sloppy-phrase, phrase-prefix, dismax,
    boosted-term and multi-field boolean queries: the port's packed
    `search_batch` equals the reference's packed `search_batch` and the
    host engine, query for query. Only the plain terms run on the device;
    phrase-prefixes and dismax are not expanded."""
    index = mixed_index()
    ref = index.reader().searcher()
    queries = [
        _t("w00"), _t("w05", "title"), _t("absent"),
        tt.RangeQuery("score", lower=10, upper=30),
        tt.PhraseQuery("body", ["w00", "w01"], slop=1),
        tt.PhrasePrefixQuery("body", ["w00", "pre"]),
        tt.PhrasePrefixQuery("body", ["pre"]),
        tt.DisjunctionMaxQuery([_t("w01"), _t("w02")]),
        tt.BoostQuery(_t("w04"), 2.0),
        tt.BooleanQuery.union([_t("w01"), _t("w01", "title")]),
        _t("w07"),
    ]
    ex = BatchExecutor(port_searcher(index), device="cpu", mode="packed")
    ex.launch_log = []
    got = ex.search_batch(to_port(queries), 7)
    want = JaxExecutor(ref, mode="packed").search_batch(queries, 7)
    for q, g, w in zip(queries, got, want):
        assert bits(g) == bits(w), repr(q)
        assert bits(g) == bits(ref.search(q, tt.TopDocs(7))), repr(q)
    # the three plain terms ran on the device, in one term batch
    assert ex.launch_log and all(r["kind"] == "packed_flat"
                                 for r in ex.launch_log)
    assert ex.host_routed == 3  # the sloppy phrase and two prefixes
    assert ex._fused().cstore is None


@pytest.mark.parametrize("query", ["boolean", "phrase"])
def test_dense_only_queries_raise_in_both(query):
    """A boolean(term) query on one field and a slop-0 phrase reach the
    dense-only scorers: the reference raises there, the port raises a
    RuntimeError naming dense mode. (A boosted term runs on the host
    engine in both: `test_search_batch_routes_as_the_reference`.)"""
    index = mixed_index()
    ref = index.reader().searcher()
    q = (tt.BooleanQuery.intersection([_t("w00"), _t("w01")])
         if query == "boolean" else tt.PhraseQuery("body", ["w00", "w01"]))
    batch = [_t("w02"), q]
    with pytest.raises((RuntimeError, AssertionError)):
        JaxExecutor(ref, mode="packed").search_batch(batch, 5)
    ex = BatchExecutor(port_searcher(index), device="cpu", mode="packed")
    with pytest.raises(RuntimeError, match="dense mode"):
        ex.search_batch(to_port(batch), 5)


def test_dense_only_paths_raise():
    index = mixed_index()
    ex = BatchExecutor(port_searcher(index), device="cpu", mode="packed")
    q_bool = pt.BooleanQuery.union([to_port(_t("w00")), to_port(_t("w01"))])
    q_phrase = pt.PhraseQuery("body", ["w00", "w01"])
    for call in (lambda: ex.search_boolean_batch([q_bool], 5),
                 lambda: ex.search_phrase_batch([q_phrase], 5),
                 lambda: ex._ensure_fused_slab(0, "body")):
        with pytest.raises(RuntimeError, match="dense mode"):
            call()
    dfp = ex._device_segments[0].field_postings("body")
    with pytest.raises(RuntimeError, match="dense mode"):
        dfp.pos_cum_np()
    with pytest.raises(ValueError):
        BatchExecutor(ex.searcher, device="cpu", mode="sparse")


def test_no_host_decode_and_a_smaller_mirror():
    """Packed mode decodes nothing on the host (`docs_np`/`tfs_np` are
    None, as in the reference) and its mirrors take fewer bytes than the
    dense fused store's rows of the same fields."""
    index, words = build_zipf_index()
    port = port_searcher(index)
    terms = [pt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    packed = BatchExecutor(port, device="cpu", mode="packed")
    packed.search_term_batch(terms, 10)
    dense = BatchExecutor(port, device="cpu")
    dense.search_term_batch(terms, 10)
    n_seg = len(port.segment_readers())
    mirror_bytes = 0
    for s in range(n_seg):
        dseg = packed._device_segments[s]
        assert dseg.mode == "packed"
        for f in ("body", "title"):
            dfp = dseg.field_postings(f)
            assert dfp.docs_np is None and dfp.tfs_np is None
            mirror_bytes += dseg.packed_mirror(f, "cpu").nbytes
        assert dense._device_segments[s].field_postings("body").docs_np \
            is not None
    cstore_bytes = dense._fused().cstore.numel() * 4
    assert 0 < mirror_bytes < cstore_bytes / 2, (mirror_bytes, cstore_bytes)


def test_for_searcher_and_warmer_honour_the_mode():
    """`DeviceSearchWarmer(mode="packed")` builds the packed mirrors and no
    fused slab, `for_searcher` returns its executor only for the same
    mode, and that executor answers term batches. The reference's warmer
    fails in packed mode (its fused store reads the dense rows, which
    packed mode does not decode): pinned."""
    from tantivy_tpu_torch.index import ReloadPolicy

    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    w.add_document(pt.Document(body="alpha bravo"))
    w.add_document(pt.Document(body="alpha charlie alpha"))
    w.commit()
    w.close()
    q = pt.TermQuery(pt.Term.from_field_text("body", "alpha"))
    warmer = DeviceSearchWarmer(["body"], queries_hint=[q], device="cpu",
                                mode="packed")
    s = index.reader(ReloadPolicy.MANUAL, warmers=[warmer]).searcher()
    ex = BatchExecutor.for_searcher(s, device="cpu", mode="packed")
    assert ex is s._warm_executor and ex.mode == "packed"
    assert not ex._fused().slabs and ex._fused().cstore is None
    assert ("body", torch.device("cpu")) in ex._device_segments[0]._mirrors
    hits = ex.search_batch([q], 10)
    assert bits(hits[0]) == bits(s.search(q, pt.TopDocs(10)))
    dense = BatchExecutor.for_searcher(s, device="cpu")
    assert dense is not ex and dense.mode == "dense"
    with pytest.raises(RuntimeError, match="dense mode"):
        DeviceSearchWarmer(["body"], with_positions=True, device="cpu",
                           mode="packed")

    ref_index, _ = build_random_index(num_docs=60, num_commits=1)
    with pytest.raises(TypeError):
        JaxWarmer(["body"], mode="packed").warm(ref_index.reader().searcher())


@pytest.mark.cuda
def test_packed_term_batch_on_cuda_matches_cpu(monkeypatch):
    from tantivy_tpu_torch.ops import packed_flat

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zstd_stub.use(monkeypatch)
    index, words = build_zipf_index()
    searcher = port_searcher(index)
    terms = [pt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    want = BatchExecutor(searcher, device="cpu",
                         mode="packed").search_term_batch(terms, 10)
    n0 = packed_flat.launches
    got = BatchExecutor(searcher, device="cuda",
                        mode="packed").search_term_batch(terms, 10)
    assert packed_flat.launches > n0
    assert [bits(g) for g in got] == [bits(w) for w in want]
