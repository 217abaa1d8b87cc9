"""The readers of the port's batch spans and of its `ub_blocks` counter,
on a recorded synthetic trace with the values worked out by hand, on a
trace of a program that records none of them, and in a traced tiny cell
on the CPU."""

import io
import json
import time

import pytest

from searchbench import spec
from searchbench.harness import Run
from tantivy_tpu_torch.utils import trace as trace_mod

NEW = ("prepare_ms", "phase2_ms", "hits_ms", "host_engine_ms",
       "unspanned_ms", "release_ms", "ship_pct")


def batch(t0, spans):
    return dict(t0=t0, t1=t0 + 1.0, queries=100, parse_s=0.02, spans=spans,
                device=None, complete=False, launches={}, bytes={})


@pytest.fixture
def trace():
    """Two batches of 1 s. The first parses for 20 ms and searches from
    0.03 s to 0.98 s: a route of 10 ms, a boolean chain (prepare 20 ms, tables 5 ms, a phase 2 of 200 ms
    holding a dispatch of 50 ms and a collect of 30 ms, a host plan of 4
    ms inside the plan, release 10 ms, hits 15 ms) and an answer loop of
    100 ms holding a host search of 60 ms. The second holds only its
    root, of 0.5 s."""
    b1 = batch(0.0, [
        ("searchbench.parse", 0.0, 0.02),
        ("batch.search", 0.03, 0.98),
        ("batch.route", 0.03, 0.04),
        ("bool.prepare", 0.04, 0.06),
        ("bool.plan_fused", 0.06, 0.30),
        ("host.segment_topk", 0.10, 0.104),
        ("bool.tables", 0.30, 0.305),
        ("bool.fused_dispatch1", 0.305, 0.35),
        ("launch.bucket", 0.31, 0.33),
        ("bool.collect1", 0.35, 0.40),
        ("bool.phase2", 0.40, 0.60),
        ("bool.fused_dispatch2a", 0.45, 0.50),
        ("bool.collect2a", 0.50, 0.53),
        ("bool.fused_dispatch2", 0.60, 0.70),
        ("bool.collect2", 0.70, 0.75),
        ("bool.release", 0.75, 0.76),
        ("batch.hits", 0.76, 0.775),
        ("batch.hits", 0.78, 0.88),
        ("host.search", 0.80, 0.86),
    ])
    b2 = batch(10.0, [("searchbench.parse", 10.0, 10.02),
                      ("batch.search", 10.1, 10.6)])
    return dict(batches=[b1, b2], plans=800, host_plans=4, kernels={},
                hbm_bytes_per_s=3.35e12)


def read(name, trace):
    return spec.reader(name).read(trace)


def test_entries_and_readers():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NEW:
        assert entries[name]["moves"] == "qps"
        assert entries[name]["workloads"] == cells
        assert callable(spec.reader(name).read)


def test_span_readers(trace):
    # route 10 + prepare 20 + tables 5
    assert read("prepare_ms", trace) == pytest.approx(35.0 / 2)
    # 200 of phase 2 less 50 of dispatch and 30 of collect
    assert read("phase2_ms", trace) == pytest.approx(120.0 / 2)
    # hits 15 + 100 less the host search's 60
    assert read("hits_ms", trace) == pytest.approx(55.0 / 2)
    assert read("release_ms", trace) == pytest.approx(10.0 / 2)
    assert read("host_engine_ms", trace) == pytest.approx(64.0 / 2)
    # the first root: 950 ms less the 845 ms its spans cover (all but
    # 0.775-0.78 s and 0.88-0.98 s); the second: all of its 500 ms
    assert read("unspanned_ms", trace) == pytest.approx((105.0 + 500) / 2)


def test_host_engine_ms_reads_zero_where_none_ran(trace):
    for b in trace["batches"]:
        b["spans"] = [s for s in b["spans"] if not s[0].startswith("host.")]
    assert read("host_engine_ms", trace) == 0.0


def test_span_readers_find_nothing_without_the_root(trace):
    """A program that records no `batch.search` (one without these
    spans) gives nothing to read, and nothing raises."""
    for b in trace["batches"]:
        b["spans"] = [s for s in b["spans"] if s[0] != "batch.search"]
    for name in NEW[:-1]:
        assert read(name, trace) is None, name
    assert read("prepare_ms", dict(trace, batches=[])) is None


def test_ship_pct(trace, monkeypatch):
    """The counts inside the traced batches' wall, and none outside."""
    t = trace_mod.Tracer()
    monkeypatch.setattr(trace_mod, "tracer", t)
    assert read("ship_pct", trace) is None
    t.enable()
    t.count("plan_stats.ub_blocks", 1000)  # before the traced batches
    first, second = trace["batches"]
    first["t0"] = time.perf_counter()
    t.count("plan_stats.ub_blocks", 300)
    t.count("plan_stats.wand_p1", 30)
    first["t1"] = time.perf_counter()
    t.count("plan_stats.wand_p2", 500)  # between them
    second["t0"] = time.perf_counter()
    t.count("plan_stats.ub_blocks", 100)
    t.count("plan_stats.wand_p2", 70)
    second["t1"] = time.perf_counter()
    assert read("ship_pct", trace) == pytest.approx(25.0)
    monkeypatch.setattr(trace_mod, "tracer", object())
    assert read("ship_pct", trace) is None


@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.phrase"])
def test_tiny_traced_cell(tiny_bench, workload):
    """A traced tiny cell reports every new metric; the spans leave less
    than 1% of the traced batches unnamed."""
    out, err = io.StringIO(), io.StringIO()
    rc = Run(workload, 2**31 + 5, 1.0, True, device="cpu", root=tiny_bench,
             data_dir=tiny_bench, err=err).execute(out)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(got)
    assert 0 < got["ship_pct"] <= 100
    assert got["unspanned_ms"] < 0.01 * got["batch_p95_ms"]
