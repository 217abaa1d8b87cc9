"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): the result line's keys, and `correct` coming out false for the
control and for each fault the cells can have, planted where the answers
are produced."""

import os
import subprocess
import sys

import numpy as np
import pytest
from conftest import ROOT, run_cell

from searchbench import control


@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.phrase",
                                      "tiny.union"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_bench, workload, trace):
    rc, res, err = run_cell(tiny_bench, workload, trace)
    assert rc == 0
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 24
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    names = set(res["metrics"])
    if trace:
        assert {"batch_p95_ms", "parse_ms", "plan_ms", "host_plan_pct",
                "dispatch_ms"} <= names
    else:
        assert names == {"qps", "setup_s"}
        assert res["metrics"]["qps"]["value"] > 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "check hits_differing: 0 (limit <= 0)" in err.splitlines()[-3]


def answers_altered(monkeypatch, alter):
    from tantivy_tpu_torch.parallel import BatchExecutor

    real = BatchExecutor.search_batch

    def search_batch(self, queries, k):
        return alter(real(self, queries, k))

    monkeypatch.setattr(BatchExecutor, "search_batch", search_batch)


def one_ulp_up(results):
    """Each query's best score one ulp higher."""
    out = [list(hits) for hits in results]
    for hits in out:
        if hits:
            s, a = hits[0]
            hits[0] = (np.nextafter(np.float32(s), np.float32(np.inf)), a)
    return out


def half_left_out(results):
    """Half of the batch answered; the rest answered with nothing."""
    half = len(results) // 2
    return list(results[:half]) + [[] for _ in results[half:]]


class Stale:
    """Every batch answered with the first batch's answers."""

    def __init__(self):
        self.first = None

    def __call__(self, results):
        if self.first is None:
            self.first = list(results)
        return self.first[:len(results)]


@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.union"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "state_unchanged"])
def test_faults_fail_the_check(tiny_bench, monkeypatch, fault, workload):
    alter = {"answer_altered": one_ulp_up, "half_left_out": half_left_out,
             "state_unchanged": Stale()}[fault]
    answers_altered(monkeypatch, alter)
    rc, res, err = run_cell(tiny_bench, workload)
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["hits_differing"]["value"] > 0


def test_failed_batches_fail_the_check(tiny_bench, monkeypatch):
    calls = []

    def alter(results):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return results

    answers_altered(monkeypatch, alter)
    rc, res, _ = run_cell(tiny_bench, "tiny.phrase")
    assert res["correct"] is False and res["failed"] == 24


@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.phrase",
                                      "tiny.union"])
def test_control_fails_the_check(tiny_bench, workload):
    """The reference in bfloat16, in the program's place, is not correct;
    in float32 it is."""
    low = control.control_run(workload, 5, 2, "bfloat16", root=tiny_bench,
                              data_dir=tiny_bench)
    assert low["hits_differing"]["value"] > 0
    same = control.control_run(workload, 5, 2, "float32", root=tiny_bench,
                               data_dir=tiny_bench)
    assert same["hits_differing"]["value"] == 0


@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.phrase"])
def test_title_body_cell_is_correct(title_body_bench, workload):
    """A cell over a title + body index, queried on both fields, is
    correct; its control is not."""
    rc, res, err = run_cell(title_body_bench, workload)
    assert rc == 0 and res["correct"] is True
    assert res["checks"]["queries_compared"]["value"] == 24
    low = control.control_run(workload, 5, 2, "bfloat16",
                              root=title_body_bench,
                              data_dir=title_body_bench)
    assert low["hits_differing"]["value"] > 0


def test_title_body_denominator_fault_fails_the_check(title_body_bench,
                                                      monkeypatch):
    """The fused chain's known fault, planted in the program's host
    engine: the title's clauses scored with the body's fieldnorms and
    average fieldnorm."""
    from tantivy_tpu_torch.index.segment_reader import SegmentReader
    from tantivy_tpu_torch.searcher import Searcher

    def body_for_title(real):
        def read(self, field, *args):
            return real(self, "body" if field == "title" else field, *args)
        return read

    monkeypatch.setattr(SegmentReader, "fieldnorms",
                        body_for_title(SegmentReader.fieldnorms))
    monkeypatch.setattr(Searcher, "field_statistics",
                        body_for_title(Searcher.field_statistics))
    rc, res, _ = run_cell(title_body_bench, "tiny.questions")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["hits_differing"]["value"] > 0


def test_no_card_no_result():
    """The command exits non-zero and prints nothing on standard output
    where no card is found (as here), or where the program is missing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "searchbench/run.py", "--workload",
         "msmarco-passage.questions", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "searchbench"),
                    tmp_path / "searchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "searchbench/run.py", "--workload",
         "msmarco-passage.questions", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.questions", "tiny.phrase"])
def test_tiny_cell_on_the_card(card, tiny_bench, workload):
    """A tiny cell through the kernels on the card, traced, is correct
    and reads the device metrics."""
    rc, res, _ = run_cell(tiny_bench, workload, trace=True, seconds=2.0,
                          device="cuda")
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert {"kernel_ms", "device_idle_pct", "h2d_ms"} <= set(res["metrics"])
