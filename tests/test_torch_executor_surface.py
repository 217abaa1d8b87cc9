"""The rest of the port's executor surface against the reference's, on the
CPU: `count_batch`, `agg_batch`, `search_batches` (pipelined batches
sharing one executor and its fused store), `prewarm`, `DeviceSearchWarmer`
with `BatchExecutor.for_searcher`, and the rule that nothing falls back to
the CPU when CUDA is missing. Fixtures are built by the reference and
opened by the port from the same bytes (`port_searcher`)."""

import json

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu_torch as pt
from tantivy_tpu.parallel import BatchExecutor as JaxExecutor
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.parallel import DeviceSearchWarmer
from tantivy_tpu_torch.parallel.shard import default_devices

from test_fused_bool import build_zipf_index
from test_mixed_batch import build_corpus
from test_torch_host_parity import bits, port_searcher, to_port
import zstd_stub

#: the aggregation requests of `bench.py`'s agg suite (its `AGG_REQUESTS`)
AGG_REQUESTS = {
    "avg_u64": {"a": {"avg": {"field": "score"}}},
    "stats_f64": {"s": {"stats": {"field": "score_f64"}}},
    "percentiles_f64": {
        "p": {"percentiles": {"field": "score_f64",
                              "percents": [95, 99, 99.9]}}
    },
    "histogram": {"h": {"histogram": {"field": "score", "interval": 10.0}}},
    "terms_1000": {"t": {"terms": {"field": "score", "size": 100}}},
    "range_with_avg": {
        "r": {
            "range": {"field": "score",
                      "ranges": [{"to": 100.0},
                                 {"from": 100.0, "to": 500.0},
                                 {"from": 500.0}]},
            "aggs": {"a": {"avg": {"field": "score_f64"}}},
        }
    },
    "composite": {
        "c": {"composite": {"size": 100,
                            "sources": [{"s": {"terms": {"field": "score"}}}]}}
    },
}


@pytest.fixture(scope="module")
def count_setup():
    """`test_count_batch.py`'s fixture: three segments of u64, i64 and f64
    fast fields."""
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_u64_field("score", tt.FAST)
    b.add_i64_field("delta", tt.FAST)
    b.add_f64_field("price", tt.FAST)
    index = tt.Index.create_in_ram(b.build())
    rng = np.random.default_rng(17)
    w = index.writer_for_tests()
    for i in range(3000):
        w.add_document(tt.Document(
            body=f"doc w{i % 7}",
            score=int(rng.integers(0, 1000)),
            delta=int(rng.integers(-500, 500)),
            price=float(rng.normal(100.0, 30.0)),
        ))
        if i in (999, 1999):
            w.commit()
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    return searcher, port_searcher(index)


def check_counts(ref, port, queries):
    """Port `count_batch` == the reference's == the port's host Count."""
    got = BatchExecutor(port, device="cpu").count_batch(to_port(queries))
    assert got == JaxExecutor(ref).count_batch(queries)
    assert got == [port.search(q, pt.Count()) for q in to_port(queries)]


def test_range_count_batch_matches_host(count_setup):
    ref, port = count_setup
    rng = np.random.default_rng(3)
    queries = []
    for _ in range(40):
        lo = int(rng.integers(0, 900))
        queries.append(tt.RangeQuery(
            "score", lower=lo, upper=lo + int(rng.integers(1, 200))))
        dlo = int(rng.integers(-500, 400))
        queries.append(tt.RangeQuery(
            "delta", lower=dlo, upper=dlo + 100,
            include_upper=bool(rng.integers(0, 2))))
        plo = float(rng.normal(100.0, 30.0))
        queries.append(tt.RangeQuery(
            "price", lower=plo, upper=plo + 20.0,
            include_lower=bool(rng.integers(0, 2))))
    # open-ended + empty + out-of-range bounds
    queries += [
        tt.RangeQuery("score", lower=None, upper=10),
        tt.RangeQuery("score", lower=990, upper=None),
        tt.RangeQuery("score", lower=2000, upper=3000),
        tt.RangeQuery("score", lower=500, upper=400),
    ]
    check_counts(ref, port, queries)


def test_count_batch_with_deletes_falls_back():
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_u64_field("score", tt.FAST)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    for i in range(100):
        w.add_document(tt.Document(body=f"t{i % 3}", score=i))
    w.commit()
    w.delete_term(tt.Term.from_field_text("body", "t0"))
    w.commit()
    w.close()
    ref = index.reader().searcher()
    check_counts(ref, port_searcher(index),
                 [tt.RangeQuery("score", lower=0, upper=50)])


def test_count_batch_mixed_queries(count_setup):
    ref, port = count_setup
    check_counts(ref, port, [
        tt.TermQuery(tt.Term.from_field_text("body", "w3")),
        tt.RangeQuery("score", lower=100, upper=300),
        tt.AllQuery(),
    ])


@pytest.fixture(scope="module")
def agg_setup():
    """Three segments with `bench.py`'s fast fields: `score` u64 in 0..999,
    `score_f64` ~ N(100, 30), ascending `ts`; a few deletes."""
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_u64_field("score", tt.FAST)
    b.add_f64_field("score_f64", tt.FAST)
    b.add_u64_field("ts", tt.FAST)
    index = tt.Index.create_in_ram(b.build())
    rng = np.random.default_rng(7)
    w = index.writer_for_tests()
    for i in range(1500):
        w.add_document(tt.Document(
            body=f"d{i % 11}",
            score=int(rng.integers(0, 1000)),
            score_f64=float(rng.normal(100.0, 30.0)),
            ts=i * 10 + int(rng.integers(0, 10)),
        ))
        if i in (499, 999):
            w.commit()
    w.commit()
    w.delete_term(tt.Term.from_field_text("body", "d3"))
    w.commit()
    w.close()
    return index.reader().searcher(), port_searcher(index)


@pytest.mark.parametrize("query", [None, "range"])
def test_agg_batch_matches_reference(agg_setup, query):
    """Every `AGG_REQUESTS` shape in one batch, over all docs and over a
    range query's docs: equal to the reference's `agg_batch` as JSON, and
    to one port `AggregationCollector` per request."""
    ref, port = agg_setup
    reqs = list(AGG_REQUESTS.values())
    q_ref = None if query is None else tt.RangeQuery("ts", lower=2000,
                                                     upper=9000)
    got = BatchExecutor(port, device="cpu").agg_batch(reqs, to_port(q_ref))
    want = JaxExecutor(ref).agg_batch(reqs, q_ref)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    q_port = to_port(q_ref) or pt.AllQuery()
    for req, g in zip(reqs, got):
        assert g == port.search(q_port, pt.AggregationCollector(req))
    assert BatchExecutor(port, device="cpu").agg_batch([]) == []


def _pipeline_batches():
    def t(word):
        return tt.TermQuery(tt.Term.from_field_text("body", word))

    batches = []
    for b in range(5):
        qs = []
        for i in range(6):
            w = f"w{(b * 6 + i) % 38:02d}"
            qs.append(t(w))
            qs.append(tt.BooleanQuery.union([t(w), t("w39")]))
            qs.append(tt.PhraseQuery("body", [w, f"w{(b + i + 1) % 38:02d}"]))
        batches.append(qs)
    return batches


def test_search_batches_pipelined_parity():
    """The pipelined multi-batch API returns exactly what per-batch
    sequential calls return, in order, with a span per batch, and the
    reference's hits (`test_mixed_batch.py`'s case)."""
    index = build_corpus(seed=11)
    ref = index.reader().searcher()
    ex = BatchExecutor(port_searcher(index), device="cpu")
    batches = _pipeline_batches()
    want = [ex.search_batch(to_port(b), 7) for b in batches]
    got = ex.search_batches([to_port(b) for b in batches], 7, pipeline=2)
    assert got == want
    assert len(ex.batch_spans) == len(batches)
    assert all(s > 0 for s in ex.batch_spans)
    # the reference's batches run in sequence first: that builds its
    # position store, which its pipelined batches would otherwise build
    # concurrently (a race of the frozen reference, ROADMAP Queue 3)
    jax_ex = JaxExecutor(ref)
    jax_seq = [jax_ex.search_batch(b, 7) for b in batches]
    jax_got = jax_ex.search_batches(batches, 7, pipeline=2)
    for b, g, j, js in zip(batches, got, jax_got, jax_seq):
        for q, gh, jh, jsh in zip(b, g, j, js):
            assert bits(gh) == bits(jh), repr(q)
            assert bits(gh) == bits(jsh), repr(q)
            assert bits(gh) == bits(ref.search(q, tt.TopDocs(7))), repr(q)
    # degenerate pipelines
    assert ex.search_batches([], 7) == []
    assert ex.search_batches([to_port(batches[0])], 7, pipeline=4) == want[:1]


def _two_field_batches(words):
    """Batches that each need a slab of their own field (and, for the
    phrase batches, the position store) on a fresh executor."""
    def t(w, field):
        return pt.TermQuery(pt.Term.from_field_text(field, w))

    return [
        [t(w, "body") for w in words[:10]],
        [t(w, "title") for w in words[:10]],
        [pt.PhraseQuery("body", [words[i], words[i + 1]]) for i in range(8)],
        [pt.BooleanQuery.union([t(words[i], "title"), t(words[i + 2],
                                                        "title")])
         for i in range(8)],
        [pt.PhraseQuery("title", [words[i], words[i + 1]]) for i in range(8)],
    ]


def test_concurrent_slab_building_gives_sequential_hits():
    """More batches in flight than cores, with a shortened thread switch
    interval, on fresh executors (so batches register different fields'
    slabs, rebuild the store and build the position store while others
    run): the hits and the planner's counters equal the sequential run's
    (a lost counter update would break the second)."""
    import itertools
    import os
    import sys

    index, words = build_zipf_index()
    port = port_searcher(index)
    workers = (os.cpu_count() or 8) + 2
    batches = list(itertools.islice(
        itertools.cycle(_two_field_batches(words)), workers))
    seq = BatchExecutor(port, device="cpu")
    want = [[bits(h) for h in seq.search_batch(b, 10)] for b in batches]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for rep in range(2):
            ex = BatchExecutor(port, device="cpu")
            got = ex.search_batches(batches, 10, pipeline=workers)
            assert [[bits(h) for h in r] for r in got] == want, rep
            assert ex.plan_stats == seq.plan_stats, rep
            assert set(ex._fused().slabs) == set(seq._fused().slabs)
            assert ex._fused().cstore.shape == seq._fused().cstore.shape
    finally:
        sys.setswitchinterval(interval)


def test_prewarm_builds_slabs_and_positions():
    index, words = build_zipf_index()
    port = port_searcher(index)
    n_seg = len(port.segment_readers())
    ex = BatchExecutor(port, device="cpu")
    hint = [pt.TermQuery(pt.Term.from_field_text("body", words[0]))]
    assert ex.prewarm(hint) == 0
    fused = ex._fused()
    assert set(fused.slabs) == {(s, "body") for s in range(n_seg)}
    assert fused.cstore is not None and fused.postore is None
    hint.append(pt.PhraseQuery("title", [words[0], words[1]]))
    assert ex.prewarm(hint, k=5, concurrency=2) == 0
    assert set(fused.slabs) == {(s, f) for s in range(n_seg)
                                for f in ("body", "title")}
    assert fused.postore is not None


def test_device_search_warmer_stashes_executor():
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    w.add_document(pt.Document(body="alpha bravo"))
    w.commit()
    from tantivy_tpu_torch.index import ReloadPolicy

    q = pt.TermQuery(pt.Term.from_field_text("body", "alpha"))
    warmer = DeviceSearchWarmer(["body"], queries_hint=[q],
                                with_positions=True, device="cpu")
    reader = index.reader(ReloadPolicy.MANUAL, warmers=[warmer])
    s = reader.searcher()
    ex = BatchExecutor.for_searcher(s, device="cpu")
    assert ex is s._warm_executor
    assert (0, "body") in ex._fused().slabs  # slab pre-built by the warmer
    assert ex._fused().postore is not None
    hits = ex.search_batch([q], 10)
    assert len(hits[0]) == 1
    # a new generation gets its own warmed executor
    w.add_document(pt.Document(body="alpha charlie"))
    w.commit()
    w.close()
    reader.reload()
    s2 = reader.searcher()
    ex2 = BatchExecutor.for_searcher(s2, device="cpu")
    assert ex2 is s2._warm_executor and ex2 is not ex
    assert len(ex2.search_batch([q], 10)[0]) == 2


def test_nothing_falls_back_to_the_cpu():
    """Without CUDA, the entry points that default to the card raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    s = index.reader().searcher()
    with pytest.raises(RuntimeError):
        BatchExecutor.for_searcher(s)
    with pytest.raises(RuntimeError):
        DeviceSearchWarmer(["body"])
    with pytest.raises(RuntimeError):
        default_devices()
    # a warmed CPU executor is not handed to a caller that asks for CUDA
    DeviceSearchWarmer(["body"], device="cpu").warm(s)
    with pytest.raises(RuntimeError):
        BatchExecutor.for_searcher(s, device="cuda")


@pytest.mark.cuda
def test_search_batches_on_cuda_streams_match_sequential(monkeypatch):
    """Three batches in flight on their own CUDA streams, on a fresh
    executor, while some add a new field's slab and the position store:
    the hits equal sequential `search_batch` on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zstd_stub.use(monkeypatch)
    index, words = build_zipf_index()
    port = port_searcher(index)
    batches = _two_field_batches(words) * 2
    want = [BatchExecutor(port, device="cpu").search_batch(b, 10)
            for b in batches]
    seq = BatchExecutor(port, device="cuda")
    got_seq = [seq.search_batch(b, 10) for b in batches]
    ex = BatchExecutor(port, device="cuda")
    got = ex.search_batches(batches, 10, pipeline=3)
    norm = [[bits(h) for h in r] for r in want]
    assert [[bits(h) for h in r] for r in got_seq] == norm
    assert [[bits(h) for h in r] for r in got] == norm
    assert len(ex._streams) == 3


class _RacingLock:
    """The store's lock, with `hook` run once just before the first
    acquisition: another thread registering a slab at that instant."""

    def __init__(self, lock, hook):
        self.lock, self.hook = lock, hook

    def __enter__(self):
        hook, self.hook = self.hook, None
        if hook is not None:
            hook()
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


@pytest.mark.parametrize("read", ["region_keys", "blk_last_device"])
def test_store_read_sees_a_slab_that_lands_meanwhile(read):
    """A slab registered between a reader's freshness check and its taking
    the store's lock is built before the reader's lazily made table, whose
    rows then cover it."""
    index, _ = build_zipf_index()
    ex = BatchExecutor(port_searcher(index), device="cpu")
    ex._ensure_fused_slab(0, "body")
    fused = ex._fused().ready()
    fused.lock = _RacingLock(fused.lock,
                             lambda: ex._ensure_fused_slab(1, "title"))
    table = fused.region_keys[0] if read == "region_keys" else \
        fused.blk_last_device()
    assert fused.slabs[(1, "title")]["offset"] >= 0
    assert len(table) == fused.num_blocks
    assert fused.region(1, "title", 0)[0] >= fused.slabs[(1, "title")][
        "offset"]
