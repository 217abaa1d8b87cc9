"""The port's per-segment Block-WAND phrase path,
`BatchExecutor.search_phrase_batch` on device="cpu" (kernel K6's twin),
against the reference's `search_phrase_batch` with Pallas off (its XLA
`probe_phrase_topk` path, the default on the CPU) and the host engine, on
the reference's phrase corpus (`test_device_phrase.build_phrase_index`)
and on the reference's host-fallback cases, each read by the port from a
byte copy with its own searcher and query classes. Hits must be equal: the
same DocAddresses in the same order, with f32 score bits equal. Also: the
port's launch chunks against the reference's recorded `probe_phrase_topk`
calls, and `search_batch`, which keeps the fused phrase chain (K2)."""

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import phrase_scorer as ref_ph
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch import parallel as port_par
from tantivy_tpu_torch.ops import phrase_scorer as ph

import zstd_stub
from test_device_phrase import build_phrase_index, sample_phrases
from test_torch_host_parity import bits, port_searcher, to_port


@pytest.fixture(scope="module")
def corpus():
    """The reference's phrase corpus (400 docs, 2 segments), built and read
    with the zstandard stand-in where the package is missing (the card's
    machine)."""
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        index, words, texts = build_phrase_index()
        yield index.reader().searcher(), words, texts


@pytest.fixture(scope="module")
def deep_corpus():
    """The same recipe at 2,400 docs in 2 segments: a term's region spans
    several blocks, so phase 2 has blocks left to ship."""
    index, words, texts = build_phrase_index(num_docs=2400, seed=7)
    return index.reader().searcher(), words, texts


def check(searcher, queries, k=10):
    """Port hits == reference hits == host hits; returns the port's
    executor (its launch log on) for counter checks."""
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_phrase_batch(to_port(queries), k)
    ref = jax_par.BatchExecutor(searcher).search_phrase_batch(queries, k)
    assert len(got) == len(ref) == len(queries)
    for q, g, r in zip(queries, got, ref):
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(k))), repr(q)
    seg = [rec for rec in port.launch_log if rec["kind"] == "seg_phrase"]
    assert len(seg) == port.plan_stats.get("phrase_seg", 0)
    return port


def phrases(texts, n, length, seed):
    rng = np.random.default_rng(seed)
    return [tt.PhraseQuery("body", p)
            for p in sample_phrases(rng, texts, n, length)]


@pytest.mark.parametrize("length", [2, 3, 4, 8])
def test_phrases_match_reference(corpus, length):
    searcher, _, texts = corpus
    queries = phrases(texts, 10, length, length)
    port = check(searcher, queries, k=int(5 + length))
    assert {rec["n_terms"] for rec in port.launch_log} == {length}
    assert not port.fallbacks


def test_five_to_seven_terms_pin_the_reference_fault(corpus):
    """5-7 term phrases get the host engine's hits, through launches of
    their own term count. A fault of the frozen reference, pinned here as
    a statement about the reference (ROADMAP Queue 3): its path gets none,
    because its 8-term bucket pads their tables with empty columns
    (`cl_len == 0`) and its `probe_phrase_topk` rejects every lane of such
    a column."""
    searcher, _, texts = corpus
    queries = phrases(texts, 2, 5, 51) + phrases(texts, 1, 7, 52)
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_phrase_batch(to_port(queries), 10)
    ref = jax_par.BatchExecutor(searcher).search_phrase_batch(queries, 10)
    for q, g, r in zip(queries, got, ref):
        want = bits(searcher.search(q, tt.TopDocs(10)))
        assert want, repr(q)
        assert bits(g) == want, repr(q)
        assert bits(r) == [], repr(q)
    assert {rec["n_terms"] for rec in port.launch_log} == {5, 7}
    assert not port.fallbacks


def test_mixed_term_counts_in_one_batch(corpus):
    """Phrases of 2 to 8 terms in one batch: one launch group per term
    count, every query with the host engine's hits."""
    searcher, _, texts = corpus
    queries = [q for n in range(2, 9) for q in phrases(texts, 2, n, 60 + n)]
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_phrase_batch(to_port(queries), 10)
    for q, g in zip(queries, got):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(10))), repr(q)
    assert {rec["n_terms"] for rec in port.launch_log} == set(range(2, 9))


def test_several_segments_with_deletes():
    index, words, texts = build_phrase_index(seed=11, num_commits=3)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[4]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert len(searcher.segment_readers()) == 3
    assert any(r.has_deletes() for r in searcher.segment_readers())
    queries = phrases(texts, 12, 2, 0) + phrases(texts, 6, 3, 1)
    check(searcher, queries)


def test_phase2_thresholds(deep_corpus, monkeypatch):
    """One phase-1 block per (query, segment) on both executors: the rest
    ships in phase 2, pruned by the phase-1 threshold."""
    monkeypatch.setattr(jax_par, "_m1", lambda: 1)
    monkeypatch.setattr(port_par, "_m1", lambda: 1)
    searcher, words, texts = deep_corpus
    queries = phrases(texts, 8, 2, 5) + [
        tt.PhraseQuery("body", [words[1], words[2]]),
        tt.PhraseQuery("body", [words[3], words[3]]),
    ]
    port = check(searcher, queries, k=3)
    assert port.plan_stats.get("wand_p2", 0) > 0
    assert {rec["phase"] for rec in port.launch_log} == {1, 2}


def test_a_missing_term(corpus):
    searcher, words, texts = corpus
    queries = [tt.PhraseQuery("body", [words[0], "zzz_missing"]),
               tt.PhraseQuery("body", ["zzz_missing", words[0], words[1]])]
    queries += phrases(texts, 3, 2, 9)
    port = check(searcher, queries)
    assert port.fallbacks == {}


def _index(docs):
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for body in docs:
        w.add_document(tt.Document(body=body))
    w.commit()
    w.close()
    return index.reader().searcher()


def leader_tf_index():
    """`test_device_phrase.TestDevicePhrase.test_high_tf_host_fallback`'s
    index: the leader repeats 40 times in a doc (> MAX_P)."""
    return _index([" ".join(["ha ho"] * 40), "ha ho hi", "ho ha"])


def wide_window_index():
    """`test_device_phrase.test_sparse_leader_dense_partner_wide_window`'s
    index: a five-doc leader block spans a dense partner's whole region, 32
    rows (wider than the reference's MAX_KW once the test lowers it to 16
    there)."""
    rng = np.random.default_rng(3)
    n = 4000
    rare = {1, 977, 1998, 2999, n - 1}
    return _index(["common rare" if i in rare
                   else f"common w{int(rng.integers(0, 30))}"
                   for i in range(n)])


def partner_tf_index():
    """A partner term 300 times in one doc (> MAX_OTHER_TF)."""
    return _index(["rare " + "dense " * 300, "rare dense", "dense rare"])


def tf17_partner_index():
    """`test_device_phrase.test_high_tf_long_doc_loses_score_argmax`'s
    index: `union` has tf 17 in a long doc, so the true per-block max tf
    sends the query to the pw = 32 rung; no fallback."""
    long_doc = ("labor union " + "union " * 16 + "filler " * 400).strip()
    return _index([long_doc, "union dues", "labor relations"])


FALLBACKS = {
    "leader_tf": (leader_tf_index, ["ha", "ho"],
                  {"phrase_seg_leader_tf": 1}),
    "wide_window": (wide_window_index, ["common", "rare"], {}),
    "partner_tf": (partner_tf_index, ["rare", "dense"],
                   {"phrase_seg_partner_tf": 1}),
    "tf17_partner": (tf17_partner_index, ["labor", "union"], {}),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_host_fallbacks(case, monkeypatch):
    """Each host fallback of the plan, counted once per (query, segment),
    with the reference's hits. A window of any width runs on the device:
    the 32-row window, which the reference sends to its host engine once
    its MAX_KW is lowered to 16 (its full-size case needs a partner of more
    than 131,072 docs), is one launch at kw = 32 on the port, with the
    reference's (host-planned) hits and the host engine's."""
    if case == "wide_window":
        monkeypatch.setattr(ref_ph, "MAX_KW", 16)
    build, terms, want = FALLBACKS[case]
    searcher = build()
    q = tt.PhraseQuery("body", terms)
    assert searcher.search(q, tt.TopDocs(10))
    port = check(searcher, [q])
    assert port.fallbacks == want
    if case == "wide_window":
        assert [rec["kw"] for rec in port.launch_log] == [32]
    if case == "tf17_partner":
        # the true block max tf of `union` (17) picks the pw = 32 rung
        assert [rec["pw"] for rec in port.launch_log] == [32]
        dfp = port._device_segments[0].field_postings("body")
        reader = port.searcher.segment_readers()[0]
        blk = dfp.term_block_start[port._term_ord(0, reader, "body",
                                                  b"union")]
        assert dfp.ensure_blk_top_tf()[blk] == 17


def test_one_launch_per_kw_rung(monkeypatch):
    """Plans of two position-window rungs (pw 16 and 32) in one group share
    one launch at pw = 32, with kw the next power of two of the widest
    item's window (8 here: widths count from the window start rounded down
    to 8 rows), where the reference launches a chunk per rung; the twin,
    scoring its items in slices of two, gives the same hits."""
    monkeypatch.setattr(ph, "_TWIN_WINDOW", 2 * 128 * 32)
    searcher = tf17_partner_index()
    queries = [tt.PhraseQuery("body", ["labor", "union"]),
               tt.PhraseQuery("body", ["labor", "relations"])]
    port = check(searcher, queries)
    assert [(rec["kw"], rec["pw"]) for rec in port.launch_log] == [(8, 32)]
    assert port.plan_stats["phrase_seg"] == 1


def test_twin_slices_give_one_pass(deep_corpus, monkeypatch):
    """The twin scores a launch's items in slices of `_TWIN_WINDOW`
    position-window elements; slices of three items give the hits of one
    pass."""
    searcher, _, texts = deep_corpus
    queries = phrases(texts, 8, 2, 71) + phrases(texts, 4, 3, 72)
    whole = check(searcher, queries)
    assert max(rec["rows"].shape[0] for rec in whole.launch_log) > 3
    monkeypatch.setattr(ph, "_TWIN_WINDOW", 3 * 128 * 16)
    check(searcher, queries)


def test_wide_rung():
    """Items of every window width share one launch per (term count,
    phase), at kw = the next power of two of the widest: `r`'s one block
    spans `a`'s 71-row region (kw = 128) in the bigram launch that also
    holds the narrow blocks of `a h` and `h m`."""
    from test_torch_probe_path import build_wide_index

    searcher = build_wide_index()
    queries = [tt.PhraseQuery("body", terms)
               for terms in (["a", "r"], ["a", "h"], ["h", "m"],
                             ["a", "a", "m"])]
    port = check(searcher, queries)
    groups = [(rec["n_terms"], rec["phase"]) for rec in port.launch_log]
    assert len(groups) == len(set(groups))  # one segment
    bigram = [rec for rec in port.launch_log
              if (rec["n_terms"], rec["phase"]) == (2, 1)]
    assert [rec["kw"] for rec in bigram] == [128]
    assert set(bigram[0]["rows"][:, 1].tolist()) == {0, 1, 2}


def test_prefixes_run_the_fused_chain(corpus):
    """Phrase-prefixes passed to `search_phrase_batch` take the fused chain
    (K2's twin) inside the same call; the phrases the per-segment path."""
    searcher, words, texts = corpus
    plain = phrases(texts, 4, 2, 3)
    prefixes = [tt.PhrasePrefixQuery("body", [words[1], "w1"]),
                tt.PhrasePrefixQuery("body", [words[2], words[5], "w"])]
    queries = [plain[0], prefixes[0], plain[1], plain[2], prefixes[1],
               plain[3]]
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_phrase_batch(to_port(queries), 10)
    for q, g in zip(queries, got):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(10))), repr(q)
    ref = jax_par.BatchExecutor(searcher).search_phrase_batch(plain, 10)
    assert [bits(g) for g in (got[0], got[2], got[3], got[5])] == [
        bits(r) for r in ref]
    kinds = {rec["kind"] for rec in port.launch_log}
    assert kinds == {"phrase", "seg_phrase"}


def test_packed_mode_raises(corpus):
    searcher, _, texts = corpus
    port = BatchExecutor(port_searcher(searcher), device="cpu",
                         mode="packed")
    with pytest.raises(RuntimeError, match="dense mode"):
        port.search_phrase_batch(to_port(phrases(texts, 1, 2, 0)), 5)


def test_ineligible_queries_raise(corpus):
    searcher, words, _ = corpus
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    sloppy = tt.PhraseQuery("body", [words[0], words[1]], slop=1)
    with pytest.raises(ValueError, match="device-eligible"):
        port.search_phrase_batch(to_port([sloppy]), 5)


def test_chunks_match_reference_probe(deep_corpus, monkeypatch):
    """Each launch of the port holds the items of the reference's chunks of
    its (segment, term count, phase) group, one chunk per kw rung: the same
    leader blocks (docs of its fused-store rows), queries and leader terms,
    with the same regions, shifts, weights, position rung and search
    depth, at a kw (the next power of two of the widest item) no narrower
    than any of their widths; and `seg_phrase_topk` (the twin and the
    merge tail) on each chunk's items, with the launch's tables and kw,
    gives the reference's `probe_phrase_topk` result per query, bit for
    bit. The reference pads each chunk (qid = num_queries); the port
    launches only the real items. At this size every plan sits in the
    pw = 16 rung and no chunk reaches a W cap."""
    monkeypatch.setattr(jax_par, "_m1", lambda: 2)
    monkeypatch.setattr(port_par, "_m1", lambda: 2)
    searcher, _, texts = deep_corpus
    queries = (phrases(texts, 6, 2, 21) + phrases(texts, 4, 3, 22)
               + phrases(texts, 3, 4, 23))
    calls = []
    real_probe = ref_ph.probe_phrase_topk

    def record(*args, **kw):
        out = real_probe(*args, **kw)
        calls.append((args, kw, np.asarray(out)))
        return out

    monkeypatch.setattr(ref_ph, "probe_phrase_topk", record)
    jax_par.BatchExecutor(searcher).search_phrase_batch(queries, 7)
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    port.search_phrase_batch(to_port(queries), 7)
    recs = port.launch_log
    assert len(recs) > 3 and {rec["phase"] for rec in recs} == {1, 2}
    calls = iter(calls)
    n_split = 0
    for rec in recs:
        rows = rec["rows"].numpy()
        st = rec["cstore"].numpy()
        keys = [(st[b, :128].tobytes(), q, t) for b, q, t in rows]
        left = sorted(keys)
        tables = [t.numpy() for t in rec["tables"]]
        n_chunks = 0
        while left:
            args, kw, want = next(calls)
            n_chunks += 1
            docs, q_pad, t_pad, valid = (np.asarray(a) for a in args[:4])
            qw, cl_start, cl_len, cl_pos, cl_shift = (np.asarray(a)
                                                      for a in args[12:17])
            mine = [(d.view(np.int32).tobytes(), q, t) for d, q, t in
                    zip(docs[valid], q_pad[valid], t_pad[valid])]
            at = [keys.index(key) for key in mine]
            for key in mine:
                left.remove(key)
            assert np.array_equal(tables[0], qw)
            assert np.array_equal(tables[2], cl_len)
            assert np.array_equal(tables[3], cl_shift)
            off = tables[1] - cl_start
            assert (off[cl_len > 0] == off[cl_len > 0][0]).all()
            assert (rec["pw"], rec["n_iters"], rec["k"],
                    rec["num_queries"]) == (kw["pw"], kw["n_iters"],
                                            kw["k"], kw["num_queries"])
            got = ph.seg_phrase_topk(
                rec["rows"][at], rec["tables"], rec["cstore"],
                rec["postore"], rec["blk_pos"], rec["blk_last"],
                k=rec["k"], num_queries=rec["num_queries"], kw=rec["kw"],
                pw=rec["pw"], n_iters=rec["n_iters"])
            assert np.array_equal(got.numpy().view(np.uint32), want)
        n_split += n_chunks > 1
    assert next(calls, None) is None
    assert n_split > 0  # some launch holds two of the reference's rungs


def test_search_batch_keeps_the_fused_chain(corpus):
    """`search_batch` runs slop-0 phrases through `_search_phrase_fused`
    (K2's twin), as before: the same launch rounds and hits as that chain
    called directly, and no per-segment phrase launch."""
    searcher, words, texts = corpus
    queries = to_port(phrases(texts, 8, 2, 31) + phrases(texts, 4, 3, 32)
                      + [tt.PhrasePrefixQuery("body", [words[1], "w1"])])
    psearcher = port_searcher(searcher)
    routed = BatchExecutor(psearcher, device="cpu")
    routed.launch_log = []
    got = routed.search_batch(queries, 10)
    direct = BatchExecutor(psearcher, device="cpu")
    direct.launch_log = []
    want = direct._search_phrase_fused(queries, 10)
    assert got == want
    assert len(routed.launch_log) == len(direct.launch_log) > 0
    assert {rec["kind"] for rec in routed.launch_log} == {"phrase"}
    for a, b in zip(routed.launch_log, direct.launch_log):
        assert [torch.equal(x[1], y[1])
                for x, y in zip(a["chunks"], b["chunks"])] == [True] * len(
                    a["chunks"])
    assert not any(kind.startswith("phrase_seg")
                   for kind in routed.plan_stats)


@pytest.mark.cuda
def test_phrase_path_launches_the_kernel_on_card(corpus):
    """The per-segment phrase plan on the card sends every chunk through K6
    (one launch per `phrase_seg` chunk) and gives the CPU executor's hits,
    5-7 term phrases included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    searcher, _, texts = corpus
    queries = to_port(phrases(texts, 10, 2, 41) + phrases(texts, 6, 3, 42)
                      + phrases(texts, 4, 8, 43) + phrases(texts, 3, 5, 44)
                      + phrases(texts, 3, 7, 45))
    psearcher = port_searcher(searcher)
    want = BatchExecutor(psearcher, device="cpu",
                         fused=False).search_phrase_batch(queries, 10)
    ex = BatchExecutor(psearcher, device="cuda")
    n0 = ph.launches
    got = ex._search_phrase_seg(queries, 10)
    n_chunks = ex.plan_stats.get("phrase_seg", 0)
    assert n_chunks > 0 and ph.launches - n0 == n_chunks
    assert got == want


@pytest.mark.cuda
def test_search_phrase_batch_runs_the_fused_chain_on_card(corpus):
    """On the card `search_phrase_batch` runs every query, phrases and
    phrase-prefixes alike, on the fused chain (K2), the reference's route
    on its accelerator: no K6 launch, and the fused chain's hits on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    searcher, words, texts = corpus
    queries = to_port(phrases(texts, 8, 2, 51) + phrases(texts, 4, 3, 52)
                      + [tt.PhrasePrefixQuery("body", [words[1], "w1"])])
    psearcher = port_searcher(searcher)
    want = BatchExecutor(psearcher, device="cpu")._search_phrase_fused(
        queries, 10)
    ex = BatchExecutor(psearcher, device="cuda")
    ex.launch_log = []
    n0 = ph.launches
    got = ex.search_phrase_batch(queries, 10)
    assert ph.launches == n0
    assert {rec["kind"] for rec in ex.launch_log} == {"phrase"}
    assert got == want
