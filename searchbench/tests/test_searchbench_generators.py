"""The generators and query logs repeat by seed; configurations, mixes
and metric readers load by name, a new mix among them as a new file; and
`BENCHMARK.json` keeps to the names, units, keys and limits its readers
expect."""

import json
import os
import re
from collections import Counter

import numpy as np
import pytest
from conftest import ROOT, TINY_CORPUS, small_mix, write_tiny_bench

from searchbench import spec
from searchbench.corpus import make_corpus
from searchbench.harness import Run
from searchbench.traffic import Traffic, batch_slots

SEEDS = (0, 1, 2**31 + 5, 2**40 + 3, -17)


@pytest.mark.parametrize("seed", SEEDS)
def test_corpus_repeats_by_seed(seed):
    a, b = make_corpus(TINY_CORPUS, seed), make_corpus(TINY_CORPUS, seed)
    assert np.array_equal(a.stream, b.stream)
    assert np.array_equal(a.starts, b.starts)
    assert np.array_equal(a.ends, b.ends)
    assert list(a.texts())[:5] == list(b.texts())[:5]
    c = make_corpus(TINY_CORPUS, seed + 1)
    assert not np.array_equal(a.stream, c.stream)


def test_fixed_order_keeps_the_lengths_and_moves_the_words():
    fixed = dict(TINY_CORPUS, doc_len=dict(TINY_CORPUS["doc_len"],
                                           order="fixed"))
    a, b = make_corpus(fixed, 3), make_corpus(fixed, 2**31 + 5)
    assert np.array_equal(a.starts, b.starts)
    assert np.array_equal(a.ends, b.ends)
    assert not np.array_equal(a.stream, b.stream)
    seeded = make_corpus(TINY_CORPUS, 3)
    assert not np.array_equal(a.ends - a.starts, seeded.ends - seeded.starts)


def test_corpus_shapes():
    c = make_corpus(TINY_CORPUS, 3)
    lens = c.ends - c.starts
    assert c.n_docs == TINY_CORPUS["docs"]
    assert lens.min() >= 1 and lens.max() <= TINY_CORPUS["doc_len"]["hi"]
    assert c.per_segment == 300
    seg, doc = c.address(np.array([0, 299, 300, 1199]))
    assert seg.tolist() == [0, 0, 1, 3] and doc.tolist() == [0, 299, 0, 299]
    texts = list(c.texts())
    assert texts[0].split() == c.words[c.stream[c.starts[0]:c.ends[0]]
                                       ].tolist()


@pytest.mark.parametrize("mix_name", ["questions", "phrase"])
def test_query_log_repeats_by_seed(mix_name):
    corpus = make_corpus(TINY_CORPUS, 1)
    mix = spec.traffic(mix_name)
    a = Traffic(mix, corpus, 77)
    assert a.batch_at(3) == Traffic(mix, corpus, 77).batch_at(3)
    assert a.batch_at(3) != a.batch_at(4)
    assert a.batch_at(0) != a.batch_at(0, purpose=1)
    assert a.batch_at(0) != Traffic(mix, corpus, 78).batch_at(0)
    assert len(a.batch_at(0)) == mix["batch"]


def shape(q: str):
    if q.startswith('"'):
        return ("phrase", len(q.split()))
    if q.startswith("+"):
        return ("and", len(q.split()))
    return ("or" if " " in q else "term", len(q.split()))


@pytest.mark.parametrize("mix_name", ["questions", "phrase"])
def test_every_batch_holds_the_same_sizes(mix_name):
    """Seeds change which terms are asked, not how many of each size."""
    corpus = make_corpus(TINY_CORPUS, 1)
    mix = spec.traffic(mix_name)
    shapes = {frozenset(Counter(shape(q) for q in
                                Traffic(mix, corpus, s).batch_at(i)).items())
              for s in (1, 2) for i in (0, 5)}
    assert len(shapes) == 1


def test_slots():
    mix = {"batch": 256, "forms": [
        {"form": "phrase", "share": 2, "terms": [2]},
        {"form": "phrase", "share": 1, "terms": [3]}]}
    n = Counter(n for _, n in batch_slots(mix))
    assert n == {2: 171, 3: 85}
    q = batch_slots(spec.traffic("questions"))
    assert Counter(n for _, n in q) == {3: 22, 4: 22, 5: 21, 6: 21, 7: 21,
                                        8: 21}


def test_distinct_terms():
    corpus = make_corpus(TINY_CORPUS, 1)
    for q in Traffic(spec.traffic("questions"), corpus, 3).batch_at(0):
        assert len(set(q.split())) == len(q.split())


def test_phrases_occur_in_the_stream():
    corpus = make_corpus(TINY_CORPUS, 1)
    text = " " + " ".join(corpus.words[corpus.stream]) + " "
    for q in Traffic(spec.traffic("phrase"), corpus, 3).batch_at(0):
        assert " " + q.strip('"') + " " in text


@pytest.mark.parametrize("cell", ["msmarco-passage.questions",
                                  "wikipedia-benchgame.phrase"])
def test_cells_load_by_name(cell):
    c = spec.Cell(spec.benchmark(), cell)
    assert c.config["name"] == c.entry["config"]
    assert c.mix["batch"] in (128, 256) and c.mix["k"] == 10
    assert [m["name"] for m in c.end_to_end] == ["qps", "setup_s"]
    assert len(c.per_layer) >= 10


def test_a_new_mix_is_a_new_file(tmp_path):
    """A mix that only this test knows, found by its name, runs."""
    mix = dict(small_mix("questions", 16),
               forms=[{"form": "and", "share": 1, "terms": [2]},
                      {"form": "term", "share": 1, "terms": [1]}])
    write_tiny_bench(tmp_path, {"test-only-mix": mix})
    run = Run("tiny.test-only-mix", 4, 0.5, False, device="cpu",
              root=str(tmp_path), data_dir=str(tmp_path))
    assert run.cell.mix["forms"][0]["form"] == "and"
    import io

    out = io.StringIO()
    assert run.execute(out) == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is True


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert os.path.exists(os.path.join(ROOT, "searchbench", "traffic",
                                           f"{w['traffic']}.json"))
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in b["end_to_end"]} == {"qps", "setup_s"}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] == "qps"
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024
