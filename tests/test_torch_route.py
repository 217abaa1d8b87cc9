"""The executor's two routes, picked by the caller
(`BatchExecutor(..., fused=...)`), each against the reference's matching
mode: `fused=False` against its XLA mode (`_pallas_mode()` None, the
default off a TPU) and `fused=True` against its Pallas mode in interpret
mode (`TANTIVY_TPU_PALLAS=1`). Every comparison is exact: the same
DocAddresses in the same order, with f32 score bits equal. The launch log's
kinds show that the route follows `fused` alone: on the CPU the kernels'
twins take the same route as the kernels on the card (the `cuda` case)."""

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
import tantivy_tpu_torch as pt
from tantivy_tpu.ops import probe_scorer as ref_ps
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.index import ReloadPolicy
from tantivy_tpu_torch.ops import (
    bool_probe,
    deep_probe,
    dense_flat,
    group_probe,
    phrase_probe,
    phrase_scorer,
)
from tantivy_tpu_torch.parallel import DeviceSearchWarmer
from tantivy_tpu_torch.parallel.shard import ShardedSearcher

import zstd_stub
from test_device_ops import build_random_index
from test_device_phrase import build_phrase_index, sample_phrases
from test_fused_bool import build_zipf_index
from test_torch_host_parity import bits, port_searcher, to_port
from test_torch_probe_path import build_wide_index

#: the launch-log kinds of the fused chains
FUSED_KINDS = {"bool", "phrase"}


def _random():
    index, words = build_random_index(num_docs=500, vocab=40, num_commits=2)
    return index.reader().searcher(), words, ("body",)


def _zipf():
    index, words = build_zipf_index()
    return index.reader().searcher(), words, ("body", "title")


def _wide():
    return build_wide_index(), ["a", "h", "m", "r", "z3"], ("body", "title")


CORPORA = {"random": _random, "zipf": _zipf, "wide": _wide}


@pytest.fixture(scope="module")
def corpus():
    """`corpus(name)`: (reference searcher, words, fields) of fixture
    `name`, built once a module."""
    built = {}

    def get(name: str):
        if name not in built:
            built[name] = CORPORA[name]()
        return built[name]

    return get


def inventory(words, fields):
    """One mixed batch: every query kind `search_batch` routes, over the
    first field (and a multi-field boolean when there are two fields)."""
    body = fields[0]
    w = words

    def t(x, field=body):
        return tt.TermQuery(tt.Term.from_field_text(field, x))

    queries = [
        t(w[0]), t(w[1]), t(w[2]), t("absent"),
        tt.BoostQuery(t(w[3]), 2.0),
        tt.BooleanQuery.intersection([t(w[0]), t(w[1])]),
        tt.BooleanQuery.union([t(w[2]), t(w[3])]),
        tt.BooleanQuery([(tt.Occur.MUST, t(w[0])),
                         (tt.Occur.SHOULD, t(w[4])),
                         (tt.Occur.MUST_NOT, t(w[1]))]),
        tt.BooleanQuery([(tt.Occur.SHOULD, t(w[i])) for i in (1, 2, 3)],
                        minimum_number_should_match=2),
        tt.PhraseQuery(body, [w[0], w[1]]),
        tt.PhraseQuery(body, [w[1], w[0], w[2]]),
        tt.PhraseQuery(body, [w[0], w[0], w[1], w[2]]),
        tt.PhrasePrefixQuery(body, [w[0], w[1][:1]]),
        tt.PhrasePrefixQuery(body, [w[2][:1]]),
        tt.DisjunctionMaxQuery([t(w[0]), t(w[3])]),
        tt.PhraseQuery(body, [w[0], w[2]], slop=2),
        tt.RangeQuery(body, w[1], w[3]),
    ]
    if len(fields) > 1:
        queries.append(tt.BooleanQuery.union([t(w[0]), t(w[0], fields[1])]))
    return queries


#: the inventory's phrase-family queries that run on the host engine on
#: the per-segment route: the phrase-prefix, the single-term prefix and
#: the sloppy phrase
SEGMENT_HOST_ROUTED = 3


def kinds(executor) -> set:
    return {rec["kind"] for rec in executor.launch_log}


def check_hits(searcher, queries, got, want, k=10):
    assert len(got) == len(want) == len(queries)
    for q, g, r in zip(queries, got, want):
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(k))), repr(q)


@pytest.fixture
def xla_mode(monkeypatch):
    monkeypatch.delenv("TANTIVY_TPU_PALLAS", raising=False)
    assert ref_ps._pallas_mode() is None


@pytest.fixture
def pallas_mode(monkeypatch):
    monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")
    assert ref_ps._pallas_mode() == "interpret"


@pytest.fixture(scope="module")
def phrase_corpus():
    index, words, texts = build_phrase_index()
    return index.reader().searcher(), words, texts


@pytest.mark.parametrize("name", list(CORPORA))
def test_segment_route_matches_reference_xla_mode(name, corpus, xla_mode):
    """`search_batch` on `fused=False` routes as the reference does in XLA
    mode: terms on K7's twin, one-field booleans on the per-segment
    boolean path, slop-0 phrases on the per-segment phrase path, nothing
    expanded, the rest on the host engine."""
    searcher, words, fields = corpus(name)
    queries = inventory(words, fields)
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_batch(to_port(queries), 10)
    ref = jax_par.BatchExecutor(searcher).search_batch(queries, 10)
    check_hits(searcher, queries, got, ref)
    assert not kinds(port) & FUSED_KINDS
    assert {"flat", "seg_phrase"} <= kinds(port)
    assert kinds(port) & {"probe", "deep"}
    assert port.host_routed == SEGMENT_HOST_ROUTED
    assert "phrase_prefix_trunc" not in port.fallbacks


def test_five_to_seven_term_phrases_pin_the_reference_fault(phrase_corpus,
                                                            xla_mode):
    """The one known departure of `fused=False` from the reference's XLA
    mode: 5-7 term phrases get the host engine's hits on the port and none
    from the reference (ROADMAP Queue 3)."""
    searcher, _, texts = phrase_corpus
    rng = np.random.default_rng(57)
    queries = [tt.PhraseQuery("body", p)
               for n in (5, 6, 7) for p in sample_phrases(rng, texts, 1, n)]
    queries.append(tt.PhraseQuery("body", sample_phrases(rng, texts, 1,
                                                         2)[0]))
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=False)
    port.launch_log = []
    got = port.search_batch(to_port(queries), 10)
    ref = jax_par.BatchExecutor(searcher).search_batch(queries, 10)
    for q, g, r in zip(queries, got, ref):
        host = bits(searcher.search(q, tt.TopDocs(10)))
        assert host and bits(g) == host, repr(q)
        assert bits(r) == ([] if len(q.term_bytes) >= 5 else host), repr(q)
    assert kinds(port) == {"seg_phrase"}
    assert port.host_routed == 0


@pytest.mark.parametrize("method", ["boolean", "phrase"])
def test_fused_route_matches_reference_pallas_mode(method, phrase_corpus,
                                                   pallas_mode):
    """`search_boolean_batch` and `search_phrase_batch` on `fused=True`
    run the fused chains alone, as the reference's do in Pallas mode."""
    searcher, words, texts = phrase_corpus
    rng = np.random.default_rng(3)

    def t(x):
        return tt.TermQuery(tt.Term.from_field_text("body", x))

    if method == "boolean":
        queries = [b for b in inventory(words, ("body",))
                   if isinstance(b, tt.BooleanQuery)]
        queries.append(tt.BooleanQuery.union([t(words[5])]))
    else:
        queries = [tt.PhraseQuery("body", p) for n in (2, 3, 4)
                   for p in sample_phrases(rng, texts, 3, n)]
        queries.append(tt.PhrasePrefixQuery("body", [words[1], "w1"]))
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=True)
    port.launch_log = []
    ex = jax_par.BatchExecutor(searcher)
    if method == "boolean":
        got = port.search_boolean_batch(to_port(queries), 10)
        ref = ex.search_boolean_batch(queries, 10)
    else:
        got = port.search_phrase_batch(to_port(queries), 10)
        ref = ex.search_phrase_batch(queries, 10)
    check_hits(searcher, queries, got, ref)
    assert kinds(port) == ({"bool"} if method == "boolean" else {"phrase"})


@pytest.mark.parametrize("fused", [False, True])
def test_search_batch_kinds_follow_the_route(fused, corpus):
    """On a one-field batch, `fused=False` logs the per-segment chains and
    the flat scorer and no fused one; `fused=True` the reverse."""
    searcher, words, fields = corpus("random")
    queries = to_port(inventory(words, fields))
    psearcher = port_searcher(searcher)
    port = BatchExecutor(psearcher, device="cpu", fused=fused)
    port.launch_log = []
    got = port.search_batch(queries, 10)
    for q, g in zip(queries, got):
        assert bits(g) == bits(psearcher.search(q, pt.TopDocs(10))), repr(q)
    if fused:
        assert kinds(port) == FUSED_KINDS
        assert port.host_routed == 1  # the sloppy phrase
    else:
        assert not kinds(port) & FUSED_KINDS
        assert {"flat", "probe", "seg_phrase"} <= kinds(port)
        assert port.host_routed == SEGMENT_HOST_ROUTED


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_prefix", [False, True])
def test_search_phrase_batch_kinds_follow_the_route(phrase_corpus, fused,
                                                    with_prefix):
    """`search_phrase_batch` on `fused=False` runs phrases on the
    per-segment plan and a prefix, which that plan does not take, on the
    fused chain in the same call; on `fused=True` everything on the fused
    chain. Hits are the host engine's either way."""
    searcher, words, texts = phrase_corpus
    rng = np.random.default_rng(8)
    queries = [tt.PhraseQuery("body", p) for n in (2, 3)
               for p in sample_phrases(rng, texts, 3, n)]
    if with_prefix:
        queries.insert(2, tt.PhrasePrefixQuery("body", [words[2], "w"]))
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=fused)
    port.launch_log = []
    got = port.search_phrase_batch(to_port(queries), 10)
    for q, g in zip(queries, got):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(10))), repr(q)
    if fused:
        assert kinds(port) == {"phrase"}
    else:
        assert kinds(port) == ({"seg_phrase", "phrase"} if with_prefix
                               else {"seg_phrase"})
        assert port.plan_stats["phrase_seg"] == sum(
            rec["kind"] == "seg_phrase" for rec in port.launch_log)


@pytest.mark.parametrize("fused", [False, True])
def test_search_boolean_batch_kinds_follow_the_route(fused, corpus):
    """`search_boolean_batch` on `fused=False` runs one-field queries on the
    per-segment path and a multi-field one on the fused chain in the same
    call, as before; on `fused=True` all of them on the fused chain."""
    searcher, words, fields = corpus("zipf")
    queries = [q for q in inventory(words, fields)
               if isinstance(q, tt.BooleanQuery)]
    port = BatchExecutor(port_searcher(searcher), device="cpu", fused=fused)
    port.launch_log = []
    got = port.search_boolean_batch(to_port(queries), 10)
    for q, g in zip(queries, got):
        if len({s.term.field for _, s in q.clauses}) == 1:
            assert bits(g) == bits(searcher.search(q, tt.TopDocs(10)))
    if fused:
        assert kinds(port) == {"bool"}
    else:
        assert "bool" in kinds(port) and kinds(port) & {"probe", "deep"}
        assert not kinds(port) & {"phrase", "flat", "seg_phrase"}


def test_sharded_segment_route_matches_single_executor(corpus):
    """Every shard's executor takes the route it is given."""
    searcher, words, fields = corpus("random")
    port = port_searcher(searcher)
    queries = to_port(inventory(words, fields))
    want = BatchExecutor(port, "cpu", fused=False).search_batch(queries, 10)
    sharded = ShardedSearcher(port, ["cpu"] * 2, fused=False)
    assert all(not ex.fused for ex in sharded._execs)
    got = sharded.search_batch(queries, 10)
    assert [bits(g) for g in got] == [bits(w) for w in want]


def test_packed_mode_has_no_fused_route(corpus):
    searcher, _, _ = corpus("random")
    port = port_searcher(searcher)
    assert BatchExecutor(port, device="cpu", mode="packed").fused is False
    assert BatchExecutor(port, device="cpu").fused is True
    with pytest.raises(ValueError, match="fused=True"):
        BatchExecutor(port, device="cpu", mode="packed", fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        BatchExecutor.for_searcher(port, device="cpu", mode="packed",
                                   fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        DeviceSearchWarmer(["body"], device="cpu", mode="packed", fused=True)


def test_warmer_and_for_searcher_honour_the_route():
    """`for_searcher` returns the warmed executor only on the route the
    warmer ran; the per-segment route's warmer builds the position store
    with its per-row offsets, which K6 reads."""
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for i in range(200):
        w.add_document(pt.Document(body=f"a{i % 7} b{i % 5} a{i % 3}"))
    w.commit()
    w.close()
    warmer = DeviceSearchWarmer(["body"], with_positions=True, device="cpu",
                                fused=False)
    s = index.reader(ReloadPolicy.MANUAL, warmers=[warmer]).searcher()
    ex = BatchExecutor.for_searcher(s, device="cpu", fused=False)
    assert ex is s._warm_executor and ex.fused is False
    assert ex._fused()._blk_pos_t is not None
    fused = BatchExecutor.for_searcher(s, device="cpu")
    assert fused is not ex and fused.fused is True
    q = pt.PhraseQuery("body", ["a1", "b1"])
    assert ex.search_batch([q], 5) == [s.search(q, pt.TopDocs(5))]


@pytest.mark.cuda
def test_segment_route_launches_its_kernels_on_card(monkeypatch):
    """On the card, `fused=False` `search_batch` launches K7, K3/K4 and K6
    as many times as the planner counts, and no K1 or K2, with the CPU
    executor's hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    zstd_stub.use(monkeypatch)
    index, words = build_random_index(num_docs=500, vocab=40, num_commits=2)
    port = port_searcher(index)
    queries = to_port(inventory(words, ("body",)))
    want = BatchExecutor(port, device="cpu", fused=False).search_batch(
        queries, 10)
    ex = BatchExecutor(port, device="cuda", fused=False)
    ex.launch_log = []
    mods = (group_probe, phrase_probe, bool_probe, deep_probe, phrase_scorer,
            dense_flat)
    before = [m.launches for m in mods]
    got = ex.search_batch(queries, 10)
    torch.cuda.synchronize()
    k1, k2, k3, k4, k6, k7 = (m.launches - n for m, n in zip(mods, before))
    st = ex.plan_stats
    n_flat = sum(rec["kind"] == "flat" for rec in ex.launch_log)
    assert (k1, k2) == (0, 0)
    assert n_flat > 0 and k7 == n_flat * dense_flat.KERNELS_PER_CALL
    assert k3 == sum(st.get(f"probe_kw{kw}", 0) for kw in (2, 8, 64)) > 0
    assert k4 == st.get("probe_deep", 0)
    assert k6 == st.get("phrase_seg", 0) > 0
    assert [bits(g) for g in got] == [bits(w) for w in want]
