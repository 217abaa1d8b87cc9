"""The port's `BatchExecutor.search_batch` (device="cpu": the kernels' plain
twins) against the reference JAX executor (Pallas kernels in interpret
mode) and the host engine, on the fixtures the reference's own tests use.
The port runs on its own searcher over a byte copy of each fixture index,
with queries rebuilt from its own classes. Hits must be equal: the same
DocAddresses in the same order, with f32 score bits equal."""

import numpy as np
import pytest

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import pallas_probe as pp
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch import parallel as port_par
from tantivy_tpu_torch.ops import fused_bool as fb
from tantivy_tpu_torch.ops.fused_store import FusedStore

from test_device_ops import build_random_index
from test_fused_bool import build_zipf_index
from test_torch_host_parity import bits, port_searcher, to_port


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TANTIVY_TPU_PALLAS", "1")


@pytest.fixture(scope="module")
def zipf():
    index, words = build_zipf_index()
    return index.reader().searcher(), words


def t(w, field="body"):
    return tt.TermQuery(tt.Term.from_field_text(field, w))


def check(searcher, queries, k=10):
    """Port hits == JAX executor hits == host hits; returns the port's
    executor for counter checks."""
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    got = port.search_batch(to_port(queries), k)
    ref = jax_par.BatchExecutor(searcher).search_batch(queries, k)
    for q, g, r in zip(queries, got, ref):
        host = searcher.search(q, tt.TopDocs(k))
        assert bits(g) == bits(r), repr(q)
        assert bits(g) == bits(host), repr(q)
    return port


def test_term_and_or_suites(zipf):
    searcher, words = zipf
    queries = [t(w) for w in words[:12]]
    queries += [tt.BooleanQuery.union([t(words[i]), t(words[i + 1])])
                for i in range(0, 16, 2)]
    queries += [tt.BooleanQuery.intersection([t(words[i]), t(words[i + 1])])
                for i in range(0, 16, 2)]
    queries.append(t("absent"))
    port = check(searcher, queries)
    assert not port.fallbacks
    assert port.host_routed == 0


def test_boost_mofn_mustnot_multifield(zipf):
    searcher, words = zipf
    queries = [
        tt.BoostQuery(t(words[5]), 4.0),
        tt.BooleanQuery.union([tt.BoostQuery(t(words[1]), 2.5), t(words[4])]),
        tt.BooleanQuery.intersection([
            tt.BoostQuery(t(words[2]), 0.5),
            tt.BoostQuery(tt.BoostQuery(t(words[3]), 2.0), 3.0),
        ]),
        tt.BooleanQuery(
            [(tt.Occur.SHOULD, t(words[i])) for i in (0, 1, 5)],
            minimum_number_should_match=2,
        ),
        tt.BooleanQuery([
            (tt.Occur.MUST, t(words[0])), (tt.Occur.MUST_NOT, t(words[1])),
        ]),
        tt.BooleanQuery.union([t(words[0], "body"), t(words[1], "title")]),
        tt.BooleanQuery([
            (tt.Occur.MUST, t(words[2], "body")),
            (tt.Occur.MUST_NOT, t(words[1], "title")),
        ]),
        tt.DisjunctionMaxQuery([t(words[3]), t(words[6], "title")]),
    ]
    check(searcher, queries)


def test_random_index_and_deletes():
    index, words = build_random_index()
    searcher = index.reader().searcher()
    queries = [t(w) for w in words[:6]] + [
        tt.BooleanQuery.union([t(words[0]), t(words[7])]),
        tt.BooleanQuery.intersection([t(words[2]), t(words[3])]),
    ]
    check(searcher, queries)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[3]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert any(r.has_deletes() for r in searcher.segment_readers())
    check(searcher, queries)


def _skewed_index(seed=0, n_docs=1500, vocab=60, alpha=1.2):
    """Zipf corpus with strong density skew between head and tail terms
    (as in tests/test_planner_properties.py)."""
    rng = np.random.default_rng(seed)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    words = np.array([f"w{i}" for i in range(vocab)])
    p = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    p /= p.sum()
    for _ in range(n_docs):
        n = int(rng.integers(3, 40))
        w.add_document(tt.Document(body=" ".join(rng.choice(words, n, p=p))))
    w.commit()
    w.close()
    return index.reader().searcher()


def test_wide_window_skip_and_explosion(monkeypatch):
    """With the widest fused window cut to 2 rows, dense-vs-sparse pairs
    have wide windows: SHOULD probes are skipped (dual reports) and MUST
    probes sliced, in the reference and in the port alike."""
    monkeypatch.setattr(pp, "fused_kw_max", lambda n_clauses: 2)
    monkeypatch.setattr(fb, "fused_kw_max", lambda n_clauses: 2)
    searcher = _skewed_index()
    queries = []
    for hi, lo in ((0, 40), (1, 55), (2, 33), (3, 47)):
        queries.append(tt.BooleanQuery.union([t(f"w{hi}"), t(f"w{lo}")]))
        queries.append(
            tt.BooleanQuery.intersection([t(f"w{lo}"), t(f"w{hi}")])
        )
    port = check(searcher, queries, k=7)
    assert port.plan_stats.get("bool_skip_rows", 0) > 0
    assert port.plan_stats.get("bool_slice_rows", 0) > 0


def test_ratchet_two_round_phase2(monkeypatch):
    monkeypatch.setattr(port_par, "_RATCHET_MIN_PER_Q", 0)
    monkeypatch.setattr(port_par, "_RATCHET_TOP_PER_Q", 1)
    monkeypatch.setattr(jax_par, "_RATCHET_MIN_PER_Q", 0)
    monkeypatch.setattr(jax_par, "_RATCHET_TOP_PER_Q", 1)
    rng = np.random.default_rng(17)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    words = [f"w{i}" for i in range(12)]
    for _ in range(900):
        n = int(rng.integers(3, 25))
        w.add_document(tt.Document(body=" ".join(rng.choice(words, n))))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    queries = []
    for i in range(12):
        a, bb = t(words[i % 12]), t(words[(i + 5) % 12])
        queries.append(tt.BooleanQuery.union([a, bb]) if i % 2
                       else tt.BooleanQuery.intersection([a, bb]))
    port = check(searcher, queries, k=5)
    assert port.plan_stats.get("bool_ratchet", 0) > 0


def test_phrase_queries_are_host_routed(zipf):
    """The slop-0 phrase runs the device phrase path; only the sloppy one
    goes to the host engine, as in the reference."""
    searcher, words = zipf
    queries = [
        tt.PhraseQuery("body", [words[0], words[1]]),
        tt.PhraseQuery("body", [words[0], words[2]], slop=1),
        t(words[0]),
    ]
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    port.launch_log = []
    got = port.search_batch(to_port(queries), 10)
    assert port.host_routed == 1
    assert any(r["kind"] == "phrase" for r in port.launch_log)
    for q, g in zip(queries, got):
        assert bits(g) == bits(searcher.search(q, tt.TopDocs(10)))


def test_fused_store_matches_reference(zipf):
    """The port's store, built natively, equals the reference's store
    carried across with `FusedStore.from_jax`, word for word."""
    searcher, _ = zipf
    ref = jax_par.BatchExecutor(searcher)
    port = BatchExecutor(port_searcher(searcher), device="cpu")
    for seg in range(len(searcher.segment_readers())):
        for field in ("body", "title"):
            ref._ensure_fused_slab(seg, field)
            port._ensure_fused_slab(seg, field)
    mine = port._fused().ready()
    carried = FusedStore.from_jax(ref._fused(), "cpu")
    assert np.array_equal(mine.cstore.numpy(), carried.cstore.numpy())
    for name in ("blk_base", "blk_last_doc", "bfac", "blk_seg"):
        assert np.array_equal(getattr(mine, name), getattr(carried, name))
    assert mine.num_blocks == carried.num_blocks
    assert mine.region(1, "body", 0) == carried.region(1, "body", 0)


def test_executor_needs_its_device(zipf):
    import torch

    searcher, _ = zipf
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchExecutor(port_searcher(searcher))
