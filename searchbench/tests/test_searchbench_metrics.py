"""Each per-layer metric's reader on a recorded synthetic trace, with the
values worked out by hand."""

import os

import pytest

from searchbench import spec, tracebook

KERNELS = {"group_probe_kernel": "group_probe",
           "merge_tail_small_kernel": "merge_tail"}
H100 = 3.35e12


def batch(t0, device, spans, complete=True, **kw):
    return dict(dict(t0=t0, t1=t0 + 1.0, queries=100, parse_s=0.01,
                     spans=spans, device=device, complete=complete,
                     launches={}, bytes={}), **kw)


@pytest.fixture
def trace():
    """Two batches of 1 s. The first: a plan span of 0.5 s holding a
    0.1 s dispatch span, a K1 launch of 2 ms at 0.70 s, a K8 launch of
    1 ms at 0.71 s and an H2D copy of 1 ms at 0.60 s. The second has two
    K1 launches of 2 ms. A third batch is traced incompletely."""
    k1 = "void group_probe_kernel(int const*, int, float const*)"
    k8 = "merge_tail_small_kernel(Args)"
    h2d = "Memcpy HtoD (Pageable -> Device)"
    b1 = batch(0.0, [(h2d, 0.600, 0.601), (k1, 0.700, 0.702),
                     (k8, 0.710, 0.711)],
               [("searchbench.parse", 0.0, 0.01),
                ("bool.plan_fused", 0.01, 0.51),
                ("bool.plan_pass1", 0.02, 0.2),
                ("bool.fused_dispatch1", 0.3, 0.4),
                ("launch.dispatch", 0.35, 0.36),
                ("bool.collect1", 0.6, 0.8)],
               bytes={"group_probe": 67_000_000, "merge_tail": 3_350_000})
    b2 = batch(10.0, [(k1, 10.1, 10.102), (k1, 10.2, 10.202)],
               [("searchbench.parse", 10.0, 10.01)],
               bytes={"group_probe": 134_000_000})
    b3 = batch(20.0, [(k1, 20.1, 20.2)], [], complete=False,
               bytes={"group_probe": 1})
    return dict(batches=[b1, b2, b3], plans=400, host_plans=10,
                kernels=KERNELS, hbm_bytes_per_s=H100)


def read(name, trace):
    return spec.reader(name).read(trace)


def test_every_metric_has_a_reader():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_batch_p95_ms(trace):
    trace["batches"][1]["t1"] = 12.0
    v = read("batch_p95_ms", trace)
    assert 1000.0 < v <= 2000.0
    assert read("batch_p95_ms", dict(trace, batches=[])) is None


def test_parse_plan_dispatch_ms(trace):
    assert read("parse_ms", trace) == pytest.approx(10.0)
    # 0.5 s of plan less the 0.1 s dispatch inside it, over 3 batches
    assert read("plan_ms", trace) == pytest.approx(400.0 / 3)
    assert read("dispatch_ms", trace) == pytest.approx(100.0 / 3)


def test_host_plan_pct(trace):
    assert read("host_plan_pct", trace) == pytest.approx(2.5)
    assert read("host_plan_pct", dict(trace, plans=0)) is None


def test_device_metrics_read_whole_batches_only(trace):
    assert read("kernel_ms", trace) == pytest.approx(3.5)
    assert read("h2d_ms", trace) == pytest.approx(0.5)
    assert read("device_idle_pct", trace) == pytest.approx(
        100 * (1 - 0.008 / 2.0))


def test_rooflines(trace):
    # K1: 201 MB at 3.35 TB/s = 0.06 ms over 6 ms of device time: 1%
    assert read("group_probe_roofline", trace) == pytest.approx(1.0)
    # K8: 3.35 MB = 1 us over 1 ms: 0.1%
    assert read("merge_tail_roofline", trace) == pytest.approx(0.1)
    assert read("kernel_roofline", trace) == pytest.approx(
        100 * (0.06 + 0.001) / 7.0)
    assert read("phrase_probe_roofline", trace) is None


def test_device_metrics_find_nothing_without_a_device_trace(trace):
    for b in trace["batches"]:
        b["device"] = None
    for name in ("kernel_ms", "h2d_ms", "device_idle_pct", "kernel_roofline",
                 "group_probe_roofline"):
        assert read(name, trace) is None
    assert tracebook.breakdown(trace) is None


def test_breakdown(trace):
    bd = tracebook.breakdown(trace)
    ops = dict(bd["device_ops"])
    assert ops["group_probe_kernel"] == pytest.approx(0.006)
    assert ops["merge_tail_small_kernel"] == pytest.approx(0.001)
    idle = dict(bd["idle_gaps"])
    assert idle["bool.plan_pass1"] == pytest.approx(0.18)
    assert idle["launch.dispatch"] == pytest.approx(0.01)
    assert idle["bool.collect1"] == pytest.approx(0.2 - 0.004)
    assert sum(idle.values()) == pytest.approx(2.0 - 0.008)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_interval_arithmetic():
    assert tracebook.union([(3, 4), (0, 2), (1, 2.5)]) == [(0, 2.5), (3, 4)]
    assert tracebook.intersect([(0, 2), (3, 5)], [(1, 4)]) == [(1, 2),
                                                               (3, 4)]
    assert tracebook.length([(0, 1), (0.5, 2)]) == 2.0
    assert tracebook.function_name(
        "void merge_tail_kernel<10>(Args)") == "merge_tail_kernel"
