"""The generators and query logs repeat by seed; configurations, mixes
and metric readers load by name, a new mix among them as a new file; and
`BENCHMARK.json` keeps to the names, units, keys and limits its readers
expect."""

import hashlib
import json
import os
import re
from collections import Counter

import numpy as np
import pytest
from conftest import (
    BODY,
    ROOT,
    TINY_CORPUS,
    TITLE_BODY,
    small_mix,
    write_tiny_bench,
)

from searchbench import spec
from searchbench.corpus import make_corpus, text_fields
from searchbench.harness import Run
from searchbench.reference import Reference
from searchbench.traffic import Traffic, batch_slots

SEEDS = (0, 1, 2**31 + 5, 2**40 + 3, -17)

#: sha256 of what a one-field configuration gives, worked out by the
#: harness as it was before configurations could name several fields:
#: the documents' texts, batches 0-3 of each mix, and the reference's
#: top-10 of batch 0 (configurations cut to 20,000 documents)
PINNED = {
    ("msmarco-passage", 1): {
        "texts":
            "4c4f4728131bcb19a273da03e348dbdd6ec7079956dd9e91ad421cffc1bb01c8",
        "questions.batches":
            "2682937a88f6b4869fc4115984b8d82e136990a7cdf039bd497808e347609cff",
        "questions.top10":
            "00054966474c92dd59c7cdd55ee78f345cb36c4920d04475ef5ec7baa477661c",
        "phrase.batches":
            "f858cdd046a1ff5929d0dd743f337f03b01abfb525b27e154b1eef41c817464f",
        "phrase.top10":
            "8180d1012885b652efc51fb28673fc99b1c275dc5e964341cbf7c4d523fbeffa",
    },
    ("msmarco-passage", 2): {
        "texts":
            "8b7934b52fbfe0f075270054b187b8c872e13e529f4b4a535fbb4bb90a7cc996",
        "questions.batches":
            "9759d6baccdcc53b7fcdfe01b6b10d32d2ce949c16cdcd8ee2b1b1c1600ecd3d",
        "questions.top10":
            "520618e1e4a23c6a96665d1b9cc91aec76a56e5bb08ba41419b9c786a5da6b64",
        "phrase.batches":
            "795a43417ba1d330f14e530ff061c8a54d353ac64da10694a05ff991f53c4525",
        "phrase.top10":
            "b80ed110e526d11e83b9cc945a7b13ff4b7c143a923086d2a66d250845caf147",
    },
    ("wikipedia-benchgame", 1): {
        "texts":
            "24143c8a1a62406c01add708c1510a087aaeeabb95ceb1f1afd7c7e99dce5e4d",
        "questions.batches":
            "2682937a88f6b4869fc4115984b8d82e136990a7cdf039bd497808e347609cff",
        "questions.top10":
            "4e35b3356d75eea74e9eafa0c59bb5c6b9b76bf9bc26681414c36e0daa938f2f",
        "phrase.batches":
            "f858cdd046a1ff5929d0dd743f337f03b01abfb525b27e154b1eef41c817464f",
        "phrase.top10":
            "490992d0a779a9e87f8a16533a25366cca1ff15595618e7eeb14bd8badd8973a",
    },
    ("wikipedia-benchgame", 2): {
        "texts":
            "84ce96a5af36315d0fbe20af5946539bcab9f85cb92747aa38111cfb3e001573",
        "questions.batches":
            "9759d6baccdcc53b7fcdfe01b6b10d32d2ce949c16cdcd8ee2b1b1c1600ecd3d",
        "questions.top10":
            "5c21c363267dd8e5973e35a0ca22a7279b24e0af498c69ff1c2fd92bf27cc9fe",
        "phrase.batches":
            "795a43417ba1d330f14e530ff061c8a54d353ac64da10694a05ff991f53c4525",
        "phrase.top10":
            "0c8f1549704aab2c4c919dcd6cacedc4870aba7fdc29a2105bd0a9029131cc30",
    },
    ("tiny", 1): {
        "texts":
            "9070ed43187d2012e5023502fd8b4ea5dd1bb913365ff9fbbb43ef23856e4549",
        "questions.batches":
            "80a01d51a5ad7fab413c273014d0faed71b99efbc5ba1cd3b55f507006361dd6",
        "questions.top10":
            "f4964e786e7b4c2e486bda37d017def0e3e9fae8ea2709a8290b257adc28c33c",
        "phrase.batches":
            "e7fa86e1b3ab8875941c2be29bc11ea10904e3232c2e38fd3fa7116292cad20a",
        "phrase.top10":
            "f379164bdb80da90bddd19265601ff62ca5435d40599681ee6e68e63dfdaeb62",
    },
    ("tiny", 2): {
        "texts":
            "9be9a6365e0e04be7828708785dd49a240d8b546588a9fd317d617e74f81fe08",
        "questions.batches":
            "79f24d2c0e277b3c8a599cd11f1d6365be6894d138dc2498641d3200ad7769fb",
        "questions.top10":
            "d2911d1af1681648869fc4b0896a14575b3fc1739ee72b709cc38ee3ae0a036f",
        "phrase.batches":
            "7add150ed47e34f1f9f37708812ef36b1990cf2845499e7e20c0e579c962b87c",
        "phrase.top10":
            "2119dc80c54d3d6edff90eabafdd77a912f1d308649e24cb9e3e2e4b595ca8ab",
    },
}


def sha(lines) -> str:
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_one_field_configurations_read_as_pinned(name, seed):
    """A configuration of one `field` gives the same documents, query
    strings and reference answers as it did before `fields` existed."""
    cfg = ({"field": "body", "corpus": TINY_CORPUS} if name == "tiny"
           else spec.config(name))
    corpus_spec = (cfg["corpus"] if name == "tiny"
                   else dict(cfg["corpus"], docs=20000))
    corpus = make_corpus(corpus_spec, seed, text_fields(cfg))
    got = {"texts": sha(corpus.texts("body"))}
    ref = Reference(corpus)
    for mix_name in ("questions", "phrase"):
        traffic = Traffic(spec.traffic(mix_name), corpus, seed)
        got[f"{mix_name}.batches"] = sha(
            q for i in range(4) for q in traffic.batch_at(i))
        got[f"{mix_name}.top10"] = sha(
            repr(ref.topk(q, 10)) for q in traffic.batch_at(0))
    assert got == PINNED[(name, seed)]


def test_text_fields():
    assert text_fields({"field": "body"}) == [{"name": "body"}]
    assert text_fields({"field": "x", "fields": TITLE_BODY}) == TITLE_BODY
    for bad in ([{"name": "a"}, {"name": "b"}],
                [dict(f, doc_len=TINY_CORPUS["doc_len"]) for f in TITLE_BODY]):
        with pytest.raises(ValueError):
            text_fields({"fields": bad})


@pytest.mark.parametrize("seed", SEEDS)
def test_a_second_field_leaves_the_first_as_it_was(seed):
    """The body of a title + body corpus is the one-field corpus bit for
    bit; each title lies in the stream, mostly inside its body, with the
    lengths of its own `doc_len`, and repeats by seed."""
    one = make_corpus(TINY_CORPUS, seed, BODY)
    two = make_corpus(TINY_CORPUS, seed, TITLE_BODY)
    assert list(two.fields) == ["title", "body"]
    assert np.array_equal(one.stream, two.stream)
    body_s, body_e = two.fields["body"]
    assert np.array_equal(one.fields["body"][0], body_s)
    assert np.array_equal(one.fields["body"][1], body_e)
    assert list(one.texts("body")) == list(two.texts("body"))
    s, e = two.fields["title"]
    lens = e - s
    assert lens.min() >= 3 and lens.max() <= 15
    inside = (s >= body_s) & (e <= body_e)
    assert inside[body_e - body_s >= 15].all() and inside.mean() > 0.8
    again = make_corpus(TINY_CORPUS, seed, TITLE_BODY)
    assert np.array_equal(again.fields["title"][0], s)
    other = make_corpus(TINY_CORPUS, seed + 1, TITLE_BODY)
    assert not np.array_equal(other.fields["title"][0], s)
    docs = list(two.documents())
    assert len(docs) == two.n_docs and list(docs[0]) == ["title", "body"]
    assert docs[7]["title"].split() == two.words[
        two.stream[s[7]:e[7]]].tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_corpus_repeats_by_seed(seed):
    a, b = make_corpus(TINY_CORPUS, seed, BODY), make_corpus(TINY_CORPUS, seed, BODY)
    assert np.array_equal(a.stream, b.stream)
    assert np.array_equal(a.fields["body"][0], b.fields["body"][0])
    assert np.array_equal(a.fields["body"][1], b.fields["body"][1])
    assert list(a.texts("body"))[:5] == list(b.texts("body"))[:5]
    c = make_corpus(TINY_CORPUS, seed + 1, BODY)
    assert not np.array_equal(a.stream, c.stream)


def test_fixed_order_keeps_the_lengths_and_moves_the_words():
    fixed = dict(TINY_CORPUS, doc_len=dict(TINY_CORPUS["doc_len"],
                                           order="fixed"))
    a, b = make_corpus(fixed, 3, BODY), make_corpus(fixed, 2**31 + 5, BODY)
    assert np.array_equal(a.fields["body"][0], b.fields["body"][0])
    assert np.array_equal(a.fields["body"][1], b.fields["body"][1])
    assert not np.array_equal(a.stream, b.stream)
    seeded = make_corpus(TINY_CORPUS, 3, BODY)
    (s, e), (s2, e2) = a.fields["body"], seeded.fields["body"]
    assert not np.array_equal(e - s, e2 - s2)


def test_corpus_shapes():
    c = make_corpus(TINY_CORPUS, 3, BODY)
    starts, ends = c.fields["body"]
    lens = ends - starts
    assert c.n_docs == TINY_CORPUS["docs"]
    assert lens.min() >= 1 and lens.max() <= TINY_CORPUS["doc_len"]["hi"]
    assert c.per_segment == 300
    seg, doc = c.address(np.array([0, 299, 300, 1199]))
    assert seg.tolist() == [0, 0, 1, 3] and doc.tolist() == [0, 299, 0, 299]
    texts = list(c.texts("body"))
    assert texts[0].split() == c.words[c.stream[starts[0]:ends[0]]].tolist()


@pytest.mark.parametrize("mix_name", ["questions", "phrase", "union"])
def test_query_log_repeats_by_seed(mix_name):
    corpus = make_corpus(TINY_CORPUS, 1, BODY)
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


@pytest.mark.parametrize("mix_name", ["questions", "phrase", "union"])
def test_every_batch_holds_the_same_sizes(mix_name):
    """Seeds change which terms are asked, not how many of each size."""
    corpus = make_corpus(TINY_CORPUS, 1, BODY)
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
    u = batch_slots(spec.traffic("union"))
    assert Counter((f["form"], n) for f, n in u) == {("or", 2): 128,
                                                      ("and", 2): 128}


@pytest.mark.parametrize("mix_name", ["questions", "union"])
def test_distinct_terms(mix_name):
    corpus = make_corpus(TINY_CORPUS, 1, BODY)
    for q in Traffic(spec.traffic(mix_name), corpus, 3).batch_at(0):
        words = q.replace("+", "").split()
        assert len(set(words)) == len(words)


def test_phrases_occur_in_the_stream():
    corpus = make_corpus(TINY_CORPUS, 1, BODY)
    text = " " + " ".join(corpus.words[corpus.stream]) + " "
    for q in Traffic(spec.traffic("phrase"), corpus, 3).batch_at(0):
        assert " " + q.strip('"') + " " in text


@pytest.mark.parametrize("cell", ["msmarco-passage.questions",
                                  "wikipedia-benchgame.phrase",
                                  "wikipedia-benchgame.union"])
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
