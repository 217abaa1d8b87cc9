"""The port's tracer (`tantivy_tpu_torch/utils/trace.py`): spans on
torch.profiler's clock, the batch spans of `BatchExecutor.search_batch`,
the planner's `ub_blocks` counter, and the chrome-trace exporter with a
profile's events. CPU only, on a tiny index; a `cuda` case checks the
exporter's device events on the card."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import tantivy_tpu_torch as tt
from tantivy_tpu_torch import parallel as port_par
from tantivy_tpu_torch.parallel import BatchExecutor
from tantivy_tpu_torch.query.parser import QueryParser
from tantivy_tpu_torch.utils.trace import debug_time, tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the spans that name the whole of a fused-route batch
BATCH = ("batch.search", "batch.route", "batch.hits")
BOOL = ("bool.prepare", "bool.tables", "bool.phase2", "bool.release")
PHRASE = ("phrase.prepare", "phrase.phase2", "phrase.release")
HOST = ("host.search", "host.segment_topk")
NEW_SPANS = BATCH + BOOL + PHRASE + HOST
#: the `plan_stats` keys the tracer counts too
TRACED = ("ub_blocks", "wand_p1", "wand_p2")


def metric_module(name):
    path = os.path.join(ROOT, "searchbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tracing():
    """Tracing on with no events; off again after the test."""
    tracer.disable()
    tracer.clear()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()


@pytest.fixture(scope="module")
def index():
    """400 documents of 5-39 Zipf-drawn words, two segments."""
    rng = np.random.default_rng(7)
    words = np.array([f"w{i}" for i in range(40)])
    p = 1.0 / np.arange(1, 41)
    p /= p.sum()
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer(memory_budget=50_000_000, num_threads=1,
                     merge_policy=tt.NoMergePolicy())
    for i in range(400):
        n = int(rng.integers(5, 40))
        w.add_document(tt.Document(body=" ".join(rng.choice(words, n, p=p))))
        if i == 199:
            w.commit()
    w.commit()
    w.close()
    return index


def parse(index, strings):
    parser = QueryParser.for_index(index, ["body"])
    return [parser.parse_query(s) for s in strings]


ORS = ["w0 w3 w7", "w1 w2", "w4 w9 w12 w20", "w5 w6 w30", "w2 w11"]
PHRASES = ['"w0 w1"', '"w1 w0 w2"', '"w3 w0"', '"w0 w2"~2']


def traced_batch(executor, queries):
    """One traced batch: (events, plan_stats differences, the tracer's
    counts of the batch's time)."""
    before = dict(executor.plan_stats)
    tracer.clear()
    t0 = time.perf_counter()
    executor.search_batch(queries, 10)
    t1 = time.perf_counter()
    after = executor.plan_stats
    keys = set(after) | set(TRACED)
    plan = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    counted = {k: tracer.counted(f"plan_stats.{k}", t0, t1) for k in keys}
    return tracer.events, plan, counted


def inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_lie_on_the_profiler_clock(tracing):
    """A record_function range opened inside a span lies within the span
    on the shared clock, and `ts` reads Unix-epoch microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with debug_time("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
    span = [e for e in tracing.events if e["name"] == "outer"][-1]
    rng = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "inner"]
    assert len(rng) == 1
    start_us = rng[0].start_ns() / 1e3
    end_us = (rng[0].start_ns() + rng[0].duration_ns()) / 1e3
    assert span["ts"] <= start_us <= end_us <= span["ts"] + span["dur"]
    assert abs(span["ts"] / 1e6 - time.time()) < 60


def test_record_keeps_perf_counter_seconds(tracing):
    """`record` takes `time.perf_counter()` seconds: two spans keep their
    distance, and the harness's zero from a known span holds."""
    t = time.perf_counter()
    tracing.record("a", t, 0.5)
    tracing.record("b", t + 2.0, 0.25)
    a, b = tracing.events[-2:]
    assert b["ts"] - a["ts"] == pytest.approx(2e6, abs=1.0)
    assert b["dur"] == pytest.approx(0.25e6)
    zero = t - a["ts"] / 1e6
    assert zero + b["ts"] / 1e6 == pytest.approx(t + 2.0, abs=1e-6)


def test_or_batch_spans(index, tracing, monkeypatch):
    """A batch of ORs (both ratchet rounds forced) records one
    `batch.search` that holds every other span of the batch, the boolean
    chain's spans among them, the ratchet's round inside `bool.phase2`;
    the planner bounds every block it ships."""
    monkeypatch.setattr(port_par, "_RATCHET_MIN_PER_Q", 0)
    monkeypatch.setattr(port_par, "_RATCHET_TOP_PER_Q", 1)
    ex = BatchExecutor(index.reader().searcher(), device="cpu")
    queries = parse(index, ORS)
    for _ in range(2):
        events, plan, counted = traced_batch(ex, queries)
        names = [e["name"] for e in events]
        assert names.count("batch.search") == 1
        root = events[names.index("batch.search")]
        assert all(inside(e, root) for e in events)
        assert set(BATCH + BOOL) <= set(names)
        assert not set(PHRASE) & set(names)
        phase2 = [e for e in events if e["name"] == "bool.phase2"]
        assert any(inside(e, p) for e in events for p in phase2
                   if e["name"] == "bool.fused_dispatch2a")
        assert plan["ub_blocks"] >= plan["wand_p1"] + plan["wand_p2"] > 0
        # the tracer counts the batch's bounded and shipped blocks, and
        # no other `plan_stats` key
        assert plan["wand_candidates"] > 0
        assert counted == {k: plan[k] if k in TRACED else 0 for k in plan}


def test_phrase_batch_spans(index, tracing):
    """A batch of phrases, one of them sloppy (the host engine's), records
    one `batch.search` holding the phrase chain's spans and the host
    search, which lies inside `batch.hits`."""
    ex = BatchExecutor(index.reader().searcher(), device="cpu")
    queries = parse(index, PHRASES)
    for _ in range(2):
        events, plan, counted = traced_batch(ex, queries)
        names = [e["name"] for e in events]
        assert names.count("batch.search") == 1
        root = events[names.index("batch.search")]
        assert all(inside(e, root) for e in events)
        assert set(BATCH + PHRASE + ("host.search",)) <= set(names)
        assert not set(BOOL) & set(names)
        hits = [e for e in events if e["name"] == "batch.hits"]
        host = [e for e in events if e["name"] == "host.search"]
        assert all(any(inside(h, b) for b in hits) for h in host)
        assert plan["ub_blocks"] >= plan["wand_p1"] + plan["wand_p2"] > 0
        assert counted == {k: plan[k] if k in TRACED else 0 for k in plan}


def test_counts_read_by_their_time(tracing):
    """A counter's increments are read by the stretch they fell in, and
    `clear` keeps them."""
    t0 = time.perf_counter()
    tracing.count("c", 2)
    t1 = time.perf_counter()
    tracing.clear()
    tracing.count("c", 5)
    tracing.count("d")
    t2 = time.perf_counter()
    assert tracing.counted("c", t0, t1) == 2
    assert tracing.counted("c", t1, t2) == 5
    assert tracing.counted("c", t0, t2) == 7
    assert tracing.counted("d", t0, t2) == 1
    assert tracing.counted("c", t2, t2 + 1.0) == 0


def test_segment_route_and_host_plans(index, tracing):
    """The per-segment route roots its batch in `batch.search` too; a
    (query, segment) plan on the host engine is `host.segment_topk`; the
    parser records no span (the caller times it)."""
    searcher = index.reader().searcher()
    queries = parse(index, ORS[:2] + PHRASES[-1:])
    assert tracing.events == []
    ex = BatchExecutor(searcher, device="cpu", fused=False)
    events, _, _ = traced_batch(ex, queries)
    names = [e["name"] for e in events]
    assert names.count("batch.search") == 1
    root = events[names.index("batch.search")]
    assert all(inside(e, root) for e in events)
    assert {"batch.route", "batch.hits", "host.search"} <= set(names)
    tracer.clear()
    reader = searcher.segment_readers()[0]
    ex._host_segment_topk(queries[0], 0, reader, 10)
    assert [e["name"] for e in tracer.events] == ["host.segment_topk"]


def test_new_spans_leave_plan_and_dispatch_ms_alone():
    """No span this file names starts with a prefix that `plan_ms` or
    `dispatch_ms` reads, so both read the same work as before."""
    plan = metric_module("plan_ms")
    dispatch = metric_module("dispatch_ms")
    prefixes = plan.PLAN + plan.CHILDREN + dispatch.DISPATCH
    for name in NEW_SPANS:
        assert not name.startswith(prefixes), name


def test_nothing_recorded_while_off(index):
    tracer.disable()
    tracer.clear()
    ex = BatchExecutor(index.reader().searcher(), device="cpu")
    t0 = time.perf_counter()
    ex.search_batch(parse(index, ORS + PHRASES), 10)
    t1 = time.perf_counter()
    assert ex.plan_stats["ub_blocks"] > 0
    assert tracer.events == []
    assert tracer.counted("plan_stats.ub_blocks", t0, t1) == 0


def test_chrome_trace_with_a_profile(tracing, tmp_path):
    """`dump_chrome_trace(path, profile)` writes the spans and the
    profile's events into one file on one clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with debug_time("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
    path = str(tmp_path / "trace.json")
    tracing.dump_chrome_trace(path, profile=prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    outer = [e for e in events if e["name"] == "outer"]
    inner = [e for e in events if e["name"] == "inner"]
    assert len(outer) == 1 and len(inner) == 1
    assert inner[0]["pid"] == "profiler cpu"
    assert inside(inner[0], outer[0])
    assert {e["ph"] for e in events} == {"X"}
    tracing.dump_chrome_trace(path)
    with open(path) as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == ["outer"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_chrome_trace_with_device_events(card, tracing, tmp_path):
    """On the card, a kernel launched and synchronised inside a span runs
    within it on the shared clock, under the device's `pid`."""
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with debug_time("outer"):
            x.mul_(2.0)
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    tracing.dump_chrome_trace(path, profile=prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    outer = [e for e in events if e["name"] == "outer"][0]
    device = [e for e in events if e["pid"] == "cuda 0"]
    assert device
    assert all(inside(e, outer) for e in device)
