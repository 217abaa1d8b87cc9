"""The port's `BatchExecutor.search_term_batch` (the flat term scorer over
the fused store, device="cpu") against the reference's (its XLA flat
scorer) and the host engine, on the reference's fixtures opened by both
packages from the same bytes: the same DocAddresses in the same order with
f32 score bits equal. A unit case holds the port's flat top-k against the
reference's `flat_topk_kernel` on a random work list."""

import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu_torch as pt
from tantivy_tpu.ops.flat_scorer import flat_topk_kernel
from tantivy_tpu.parallel import BatchExecutor as JaxExecutor
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.ops.flat_scorer import flat_topk
from tantivy_tpu_torch.ops.fused_store import build_cstore_np
from tantivy_tpu_torch.query.bm25 import compute_tf_cache

from test_device_ops import build_random_index
from test_fused_bool import build_zipf_index
from test_torch_host_parity import bits, port_searcher, to_port
import zstd_stub

TERMINATED = 2**31 - 1


def check(searcher, terms, k=10, device="cpu"):
    """Port == reference `search_term_batch` == host, in f32 bits; returns
    the port's executor."""
    ex = BatchExecutor(port_searcher(searcher), device=device)
    got = ex.search_term_batch(to_port(terms), k)
    want = JaxExecutor(searcher).search_term_batch(terms, k)
    assert len(got) == len(terms)
    for term, g, w in zip(terms, got, want):
        host = searcher.search(tt.TermQuery(term), tt.TopDocs(k))
        assert bits(g) == bits(w), term
        assert bits(g) == bits(host), term
    return ex


def test_exact_match_vs_host():
    index, words = build_random_index()
    searcher = index.reader().searcher()
    check(searcher, [tt.Term.from_field_text("body", w) for w in words])


def test_with_deletes():
    index, words = build_random_index(num_commits=1)
    w = index.writer_for_tests()
    w.delete_term(tt.Term.from_field_text("body", words[0]))
    w.commit()
    w.close()
    searcher = index.reader().searcher()
    assert searcher.segment_readers()[0].has_deletes()
    check(searcher, [tt.Term.from_field_text("body", w_) for w_ in words[:8]])


def test_missing_term():
    index, _ = build_random_index(num_docs=50, num_commits=1)
    ex = BatchExecutor(port_searcher(index), device="cpu")
    res = ex.search_term_batch(
        [pt.Term.from_field_text("body", "doesnotexist")], k=5
    )
    assert res == [[]]
    assert ex.search_term_batch([], k=5) == []


@pytest.mark.parametrize("fixture", ["random", "zipf"])
@pytest.mark.parametrize("k", [1, 10])
def test_matches_reference(fixture, k):
    """Both fixtures; the Zipf one mixes `body` and `title` terms in one
    batch, so one flat launch per segment holds rows of two slabs."""
    if fixture == "random":
        index, words = build_random_index(seed=5, num_commits=3)
        terms = [tt.Term.from_field_text("body", w) for w in words]
    else:
        index, words = build_zipf_index()
        terms = [tt.Term.from_field_text(f, w)
                 for w in words for f in ("body", "title")]
    terms.append(tt.Term.from_field_text("body", "absent"))
    check(index.reader().searcher(), terms, k=k)


def test_k_above_the_kernel_cap_takes_the_row_stage():
    """k = 200 (above K7's per-query cap of 128): every flat chunk takes the
    row stage and the torch merge, counted in `plan_stats["flat_rows_k"]`;
    hits still equal the reference's and the host engine's. At k = 10 no
    chunk takes it."""
    index, words = build_zipf_index()
    searcher = index.reader().searcher()
    terms = [tt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    for k, rows_route in ((200, True), (10, False)):
        ex = check(searcher, terms, k=k)
        ex.launch_log = []
        ex.search_term_batch(to_port(terms), k)
        chunks = sum(rec["kind"] == "flat" for rec in ex.launch_log)
        assert chunks > 0
        want = 2 * chunks if rows_route else 0
        assert ex.plan_stats.get("flat_rows_k", 0) == want, ex.plan_stats


@pytest.mark.parametrize("k", [1, 10])
def test_query_split_across_chunks(k, monkeypatch):
    """Chunks of 7 work items: one query's blocks land in several flat
    calls, whose per-query top-k the executor merges; hits still equal the
    reference's and the host engine's."""
    from tantivy_tpu_torch.ops import flat_scorer

    monkeypatch.setattr(flat_scorer, "CHUNK", 7)
    index, words = build_random_index(num_docs=4000, vocab=12, num_commits=2)
    searcher = index.reader().searcher()
    ex = BatchExecutor(port_searcher(searcher), device="cpu")
    ex.launch_log = []
    terms = [tt.Term.from_field_text("body", w) for w in words]
    ex.search_term_batch(to_port(terms), k)
    calls = [rec["args"] for rec in ex.launch_log if rec["kind"] == "flat"]
    seen: dict = {}
    for args in calls:
        for q in np.unique(args[2].numpy()):
            seen[int(q)] = seen.get(int(q), 0) + 1
    assert max(seen.values()) > 1, "no query spans two chunks"
    check(searcher, terms, k=k)


def test_two_phase_prunes():
    """A dense corpus: terms span many blocks per segment, so phase 2 ships
    only the blocks that can beat the phase-1 threshold; hits stay exact."""
    index, words = build_random_index(num_docs=4000, vocab=12, num_commits=2)
    ex = check(index.reader().searcher(),
               [tt.Term.from_field_text("body", w) for w in words], k=3)
    st = ex.plan_stats
    assert st["wand_p1"] + st.get("wand_p2", 0) < st["wand_candidates"], st


def _random_store(rng, nb=96, max_doc=5000):
    """Sorted doc rows with TERMINATED padding, tfs with many ties, norm ids
    and an alive mask with deletes."""
    docs = np.full((nb, 128), TERMINATED, dtype=np.uint32)
    tfs = np.ones((nb, 128), dtype=np.uint32)
    for b in range(nb):
        n = int(rng.integers(1, 129))
        docs[b, :n] = np.sort(rng.choice(max_doc, n, replace=False))
        tfs[b, :n] = rng.integers(1, 4, n)
    norm_ids = rng.integers(0, 6, max_doc).astype(np.uint8)
    alive = rng.random(max_doc) > 0.1
    return docs, tfs, norm_ids, alive


@pytest.mark.parametrize("k", [1, 10, 200])
def test_flat_topk_matches_reference_kernel(k):
    """The port's `flat_topk` against the reference's jitted
    `flat_topk_kernel` on one random work list (repeated blocks, ties,
    deleted docs, padding lanes): the packed [2, Q, k] outputs are equal
    word for word."""
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    docs, tfs, norm_ids, alive = _random_store(rng)
    cache = compute_tf_cache(np.float32(7.3))
    Q, W = 9, 300
    blocks = rng.integers(0, docs.shape[0], W)
    qid = rng.integers(0, Q, W).astype(np.int32)
    weights = rng.uniform(0.5, 3.0, Q + 1).astype(np.float32)
    want = np.asarray(flat_topk_kernel(
        jnp.asarray(docs[blocks]), jnp.asarray(tfs[blocks]),
        jnp.asarray(qid), jnp.ones(W, dtype=bool), jnp.asarray(norm_ids),
        jnp.asarray(alive), jnp.asarray(weights),
        jnp.asarray(np.tile(cache, (Q + 1, 1))), k, Q,
    ))
    cstore = torch.from_numpy(
        build_cstore_np(docs, tfs, norm_ids, alive, cache).view(np.int32)
    )
    got = flat_topk(cstore, torch.from_numpy(blocks), torch.from_numpy(qid),
                    torch.from_numpy(weights), k, Q).numpy()
    assert got.shape == want.shape == (2, Q, k)
    assert np.array_equal(got.view(np.uint32), want)
    # every query has hits, and ties (6 norm ids x 3 tfs) cut its top-k
    sc = got[0].view(np.float32)
    assert np.isfinite(sc[:, 0]).all()


@pytest.mark.parametrize("k,route", [(1, "topk"), (128, "topk"),
                                     (129, "rows")])
def test_dispatch_flat_reports_route(k, route, monkeypatch):
    """`dispatch_flat` counts each chunk under the route `flat_topk` took
    (K7 whole up to its cap, the row stage and the merge tail above), and
    each chunk's output is `flat_topk`'s on that chunk."""
    from tantivy_tpu_torch.ops import flat_scorer

    monkeypatch.setattr(flat_scorer, "CHUNK", 64)
    rng = np.random.default_rng(k)
    docs, tfs, norm_ids, alive = _random_store(rng)
    cstore = torch.from_numpy(build_cstore_np(
        docs, tfs, norm_ids, alive,
        compute_tf_cache(np.float32(7.3))).view(np.int32))
    Q, W = 5, 150
    rows = rng.integers(0, docs.shape[0], W)
    qid = rng.integers(0, Q, W).astype(np.int32)
    weights = rng.uniform(0.5, 3.0, Q + 1).astype(np.float32)
    routes = {}
    outs = flat_scorer.dispatch_flat(cstore, rows, qid, weights, k, Q,
                                     routes=routes)
    assert routes == {route: 3}
    for lo, got in zip(range(0, W, 64), outs):
        want = flat_topk(cstore, torch.from_numpy(rows[lo:lo + 64]),
                         torch.from_numpy(qid[lo:lo + 64]),
                         torch.from_numpy(weights), k, Q)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_term_batch_on_cuda_matches_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zstd_stub.use(monkeypatch)
    index, words = build_zipf_index()
    searcher = port_searcher(index)
    terms = [pt.Term.from_field_text(f, w)
             for w in words for f in ("body", "title")]
    want = BatchExecutor(searcher, device="cpu").search_term_batch(terms, 10)
    got = BatchExecutor(searcher, device="cuda").search_term_batch(terms, 10)
    assert [bits(g) for g in got] == [bits(w) for w in want]
