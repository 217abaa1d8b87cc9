"""The port's phrase path (`search_batch(device="cpu")`: kernel K2's plain
twin) against the reference JAX executor (Pallas kernels in interpret mode)
and the host engine, on the reference's own phrase corpus
(`test_device_phrase.build_phrase_index`: 400 docs, 2 segments), which the
port reads from a byte copy with its own searcher and query classes. Hits
must be equal: the same DocAddresses in the same order, with f32 score bits
equal. Also: the port's position store against the reference's, and the
port's phrase constants against the reference's."""

import numpy as np
import pytest

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import pallas_phrase as php
from tantivy_tpu.ops import phrase_scorer
from tantivy_tpu.query.phrase_query import PhrasePrefixQuery
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch import parallel as port_par
from tantivy_tpu_torch.ops import fused_phrase as fp
from tantivy_tpu_torch.ops import phrase_scorer as port_ph
from tantivy_tpu_torch.ops.fused_store import FusedStore

from test_device_phrase import build_phrase_index, sample_phrases
from test_torch_host_parity import bits, port_searcher, to_port


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")


@pytest.fixture(scope="module")
def corpus():
    index, words, texts = build_phrase_index()
    return index.reader().searcher(), words, texts


def check(searcher, queries, k=10):
    """Port hits == JAX executor hits == host hits; returns the port's
    executor for counter checks."""
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    port.launch_log = []
    got = port.search_batch(to_port(queries), k)
    ref = jax_par.BatchExecutor(searcher).search_batch(queries, k)
    for q, g, r in zip(queries, got, ref):
        host = searcher.search(q, tt.TopDocs(k))
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(host), repr(q)
    return port


def _phrase_launches(port):
    return [r for r in port.launch_log if r["kind"] == "phrase"]


def _partners(length):
    from tantivy_tpu_torch.ops.probe_scorer import t_bucket

    return t_bucket(length) - 1


@pytest.mark.parametrize("length", [2, 3, 4])
def test_phrases_match_reference(corpus, length):
    searcher, _, texts = corpus
    rng = np.random.default_rng(length)
    queries = [
        tt.PhraseQuery("body", p)
        for p in sample_phrases(rng, texts, 12, length)
    ]
    port = check(searcher, queries)
    assert port.host_routed == 0 and not port.fallbacks
    launched = {r["n_partners"] for r in _phrase_launches(port)}
    assert launched == {_partners(length)}


def test_no_match_phrase(corpus):
    searcher, words, _ = corpus
    port = check(searcher, [
        tt.PhraseQuery("body", [words[0], "zzz_missing"]),
        tt.PhraseQuery("body", [words[0], words[0], words[0], words[0],
                                words[0], words[0]]),
    ])
    assert port.host_routed == 0


def test_phrases_with_deletes():
    index, words, texts = build_phrase_index(num_docs=200, seed=7)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[2]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert any(r.has_deletes() for r in searcher.segment_readers())
    rng = np.random.default_rng(3)
    check(searcher, [
        tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 10, 2)
    ])


def test_forced_reanchoring(corpus, monkeypatch):
    """Tiny partner caps force re-anchoring through the denser term (and
    host fallback when both anchors are over the cap), in the reference and
    in the port alike; exactness must hold."""
    monkeypatch.setattr(php, "PARTNER_POS_CAP", 64)
    monkeypatch.setattr(fp, "PARTNER_POS_CAP", 64)
    searcher, _, texts = corpus
    rng = np.random.default_rng(2)
    port = check(searcher, [
        tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 12, 2)
    ])
    assert (port.plan_stats.get("phrase_reanchor", 0)
            + port.fallbacks.get("phrase_wide", 0)) > 0


def test_sub_batches_past_prow_tier(corpus, monkeypatch):
    """Plan rows are one per (query, segment): 24 queries x 2 segments
    exceed a forced 8-row tier, so both executors sub-batch."""
    tier = staticmethod(lambda n, Tb=2: 8)
    monkeypatch.setattr(jax_par.BatchExecutor, "_prow_tier", tier)
    monkeypatch.setattr(BatchExecutor, "_prow_tier", tier)
    searcher, _, texts = corpus
    rng = np.random.default_rng(11)
    port = check(searcher, [
        tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 24, 2)
    ])
    assert len(_phrase_launches(port)) >= 3


def test_phrase_prefixes(corpus):
    """Multi-term prefixes ride the phrase launch (one plan row per
    (segment, expansion)); single-term prefixes expand into term
    sub-queries on the boolean path; results merge by dedup-keep-max."""
    searcher, words, texts = corpus
    rng = np.random.default_rng(5)
    queries = [
        PhrasePrefixQuery("body", [a, b[:2]])
        for a, b in sample_phrases(rng, texts, 6, 2)
    ]
    queries += [
        PhrasePrefixQuery("body", p[:-1] + [p[-1][:2]])
        for p in sample_phrases(rng, texts, 3, 3)
    ]
    queries += [PhrasePrefixQuery("body", ["w1"]),
                PhrasePrefixQuery("body", ["w"])]
    port = check(searcher, queries)
    assert port.host_routed == 0 and not port.fallbacks
    kinds = {r["kind"] for r in port.launch_log}
    assert kinds == {"bool", "phrase"}


def test_phrases_mixed_with_booleans(corpus):
    searcher, words, texts = corpus
    rng = np.random.default_rng(4)

    def t(x):
        return tt.TermQuery(tt.Term.from_field_text("body", x))

    queries = [
        tt.PhraseQuery("body", sample_phrases(rng, texts, 1, 2)[0]),
        tt.BooleanQuery.union([t(words[0]), t(words[1])]),
        t(words[2]),
        PhrasePrefixQuery("body", [words[3], "w1"]),
        tt.PhraseQuery("body", sample_phrases(rng, texts, 1, 3)[0], slop=1),
        tt.BooleanQuery.intersection([t(words[4]), t(words[5])]),
    ]
    port = check(searcher, queries)
    assert port.host_routed == 1  # the sloppy phrase


def test_host_routed_phrase_family(corpus):
    """Only what the reference also answers on the host counts: a sloppy
    phrase, a phrase longer than the device's term limit, and a single-term
    prefix whose expansion the host would truncate per segment."""
    searcher, words, texts = corpus
    rng = np.random.default_rng(9)
    long_phrase = sample_phrases(rng, texts, 1, port_par.PHRASE_T_MAX + 1)[0]
    port = check(searcher, [
        tt.PhraseQuery("body", [words[0], words[1]], slop=2),
        tt.PhraseQuery("body", long_phrase),
        PhrasePrefixQuery("body", ["w"], max_expansions=3),
        tt.PhraseQuery("body", sample_phrases(rng, texts, 1, 2)[0]),
    ])
    assert port.host_routed == 3
    assert port.fallbacks == {"phrase_prefix_trunc": 1}


def test_positions_of_field_without_positions():
    """A batch whose boolean clause reads a STRING field (no positions)
    and whose phrase reads a TEXT field: the port builds the position store
    with no positions for the STRING slab. (The reference's
    `ensure_positions` asserts on that slab, so only the host engine is
    compared here.)"""
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_text_field("tag", tt.STRING)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(12)]
    for i in range(300):
        w.add_document(tt.Document(body=" ".join(rng.choice(words, 12)),
                                   tag=f"t{i % 5}"))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    queries = [
        tt.TermQuery(tt.Term.from_field_text("tag", "t1")),
        tt.PhraseQuery("body", ["w1", "w2"]),
    ]
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    got = port.search_batch(to_port(queries), 10)
    for q, g in zip(queries, got):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(10))), repr(q)
    assert port.host_routed == 0
    with pytest.raises(AssertionError):
        jax_par.BatchExecutor(searcher).search_batch(queries, 10)


def test_position_store_matches_reference(corpus):
    """The port's position store, built natively, equals the reference's
    word for word (as int32), with the same block offsets and sizes, and
    `FusedStore.from_jax` carries all of it across."""
    searcher, _, _ = corpus
    ref = jax_par.BatchExecutor(searcher)
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    for seg in range(len(searcher.segment_readers())):
        ref._ensure_fused_slab(seg, "body")
        port._ensure_fused_slab(seg, "body")
    ref_store = ref._fused().ready()
    ref_store.ensure_positions()
    mine = port._fused().ready()
    mine.ensure_positions()
    want = np.asarray(ref_store.postore).view(np.int32)
    assert np.array_equal(mine.postore.numpy(), want)
    assert np.array_equal(mine.blk_pos, ref_store.blk_pos)
    assert (mine.num_pos, mine.pos_rows) == (ref_store.num_pos,
                                             ref_store.pos_rows)
    carried = FusedStore.from_jax(ref_store, "cpu")
    assert np.array_equal(carried.postore.numpy(), want)
    assert np.array_equal(carried.blk_pos, ref_store.blk_pos)
    assert (carried.num_pos, carried.pos_rows) == (ref_store.num_pos,
                                                   ref_store.pos_rows)


def test_phrase_constants_match_reference():
    assert port_par.PHRASE_T_MAX == phrase_scorer.T_MAX
    # the per-segment phrase planner's constants the port keeps; the
    # reference's W, kw and term-count ladders and its MAX_KW bound XLA
    # shapes and have no counterpart in the port
    for name in ("T_MAX", "MAX_P", "_PW_LADDER", "MAX_OTHER_TF",
                 "_ITER_LADDER"):
        assert getattr(port_ph, name) == getattr(phrase_scorer, name), name
    for n in (1, 2, 255, 256, 257, 16384, 16385, 2**20):
        assert port_ph._iter_bucket(n) == phrase_scorer._iter_bucket(n)
    for n in (1, 16, 17, 32, 33, 64, 65, 256):
        assert port_ph._pw_bucket(n) == phrase_scorer._pw_bucket(n)[0]
    assert fp._PHRASE_RUNGS == php._PHRASE_RUNGS
    assert (fp.ANCHOR_POS_CAP, fp.PARTNER_POS_CAP) == (
        php.ANCHOR_POS_CAP, php.PARTNER_POS_CAP)
    assert fp.max_slab_rows() == php.max_slab_rows()
    for S in (1, 3, 7):
        assert fp._phrase_scal_layout(S) == php._phrase_scal_layout(S, 8)[0]
