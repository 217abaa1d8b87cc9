"""The port's `ops/term_scorer._topk_kernel` (kernel K7's cache form and a
per-query merge; on the CPU the kernel's twin) against the reference's
`tantivy_tpu.ops.term_scorer._topk_kernel` under JAX on the CPU: the same
numpy inputs, made from a seed, give the same scores as f32 bits and the
same docs as u32, the -inf slots of a query with fewer than k live docs
included (tolerance: none). The `cuda` cases run the same inputs through
the kernel on the card."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops.term_scorer import _topk_kernel as ref_topk
from tantivy_tpu_torch.ops.term_scorer import _topk_kernel

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import zstd_stub  # noqa: E402

TERMINATED = 2**31 - 1

#: synthetic kinds; "tiny_index" is the arrays `__graft_entry__.entry()`
#: builds over its tiny index
KINDS = ("tiny_index", "ties", "dead", "invalid", "alive_none", "sparse",
         "q1_b1")


def _tiny_index_args():
    import __graft_entry__ as graft

    _, args = graft.entry()
    return [np.asarray(a) for a in args]


def make_case(kind: str, seed: int = 0):
    """(docs, tfs [Q, B, 128] u32, valid [Q, B], norm_ids u8, weights [Q],
    caches [Q, 256], alive or None) of `kind`, numpy."""
    if kind == "tiny_index":
        return _tiny_index_args()
    rng = np.random.default_rng(seed + 100 * KINDS.index(kind))
    Q, B = (1, 1) if kind == "q1_b1" else (5, 3)
    max_doc = 3000
    # docs in no order across rows (and lanes), so ties across rows follow
    # the flat index, not the doc; TERMINATED padding inside rows
    docs = rng.integers(0, max_doc, (Q, B, 128)).astype(np.uint32)
    docs[rng.random((Q, B, 128)) < 0.2] = TERMINATED
    if kind == "sparse":
        docs[rng.random((Q, B, 128)) < 0.95] = TERMINATED
    tfs = rng.integers(1, 4, (Q, B, 128)).astype(np.uint32)
    tfs[docs == TERMINATED] = 0
    valid = np.ones((Q, B), bool)
    if kind == "invalid":
        valid = rng.random((Q, B)) < 0.5
        valid[0, 0] = False
    norm_ids = rng.integers(0, 256, max_doc).astype(np.uint8)
    weights = rng.uniform(0.5, 3.0, Q).astype(np.float32)
    caches = np.tile(rng.uniform(0.3, 3.0, 256).astype(np.float32), (Q, 1))
    if kind == "ties":
        tfs[:] = 1
        norm_ids[:] = 7
    alive = rng.random(max_doc) >= (0.5 if kind == "dead" else 0.1)
    if kind == "alive_none":
        alive = None
    return [docs, tfs, valid, norm_ids, weights, caches, alive]


def reference(args, k):
    out = ref_topk(*(None if a is None else jnp.asarray(a) for a in args),
                   k=k)
    return np.asarray(out[0]), np.asarray(out[1])


def port(args, k, device="cpu"):
    t = [None if a is None else torch.from_numpy(np.array(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in args]
    sc, docs = _topk_kernel(*t, k)
    return sc.cpu().numpy(), docs.cpu().numpy()


def _k(args, which: str) -> int:
    B = args[0].shape[1]
    return {"1": 1, "10": 10, "128": 128, "full": B * 128,
            "200": min(200, B * 128)}[which]


def assert_same(got, want):
    assert got[0].shape == want[0].shape
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    assert np.array_equal(got[1].view(np.uint32), want[1].view(np.uint32))


@pytest.mark.parametrize("which", ["1", "10", "128", "200", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_reference(kind, which):
    args = make_case(kind)
    k = _k(args, which)
    want = reference(args, k)
    assert_same(port(args, k), want)
    sc = want[0]
    if kind in ("ties", "sparse", "invalid", "dead") and which == "full":
        # the case holds what it claims: -inf slots with their own docs
        assert np.isinf(sc).any()
        assert (want[1][np.isinf(sc)] != TERMINATED).any()
    if kind == "ties" and which == "full":
        # ties cut every query's top-10
        assert (sc[:, 9] == sc[:, 10]).all()


def test_ties_follow_the_flat_index_across_rows():
    """Equal scores in several rows: the reference keeps the lowest flat
    index b * 128 + lane, not the lowest doc, and so does the port."""
    args = make_case("ties")
    docs = args[0]
    k = 3 * 128
    want = reference(args, k)
    assert_same(port(args, k), want)
    live = np.isfinite(want[0][0])
    d = want[1][0][live]
    assert docs.shape[1] == 3 and (want[0][0][live] == want[0][0][0]).all()
    assert not (np.diff(d.astype(np.int64)) > 0).all(), (
        "docs of the tied slots should not be in doc order")


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("kind", ["tiny_index", "sparse", "invalid"])
def test_cache_form_takes_items_in_any_query_order(kind, k):
    """K7's cache form (`dense_flat_cache`) over `_topk_kernel`'s Q * B
    rows with the queries interleaved (each query's rows kept in order):
    the reference's top-k of every query, -inf slots of a query with fewer
    than k live lanes included."""
    from tantivy_tpu_torch.ops.dense_flat import dense_flat_cache

    args = make_case(kind)
    docs, tfs, valid, norm_ids, weights, caches, alive = args
    Q, B, _ = docs.shape
    k = min(k, B * 128)
    want = reference(args, k)
    # item order: row b of every query, then row b + 1 of every query
    order = np.arange(Q * B).reshape(Q, B).T.reshape(-1)

    def rows(a):
        a = a.reshape(Q * B, -1)[order] if a.ndim == 3 else a.reshape(-1)[
            order]
        return torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a))

    def whole(a):
        return None if a is None else torch.from_numpy(np.array(a))

    got = dense_flat_cache(
        rows(docs), rows(tfs), rows(valid),
        whole((order // B).astype(np.int32)), whole(norm_ids), whole(alive),
        whole(weights), whole(caches), k=k, num_queries=Q)
    assert_same(tuple(x.numpy() for x in got), want)
    if kind == "sparse" and k == 128:
        assert np.isinf(want[0]).any()


def test_k_above_the_rows_raises():
    args = make_case("q1_b1")
    with pytest.raises(ValueError):
        port(args, 129)
    with pytest.raises(ValueError):
        port(args, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_on_cuda_matches_reference_and_twin(kind, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zstd_stub.use(monkeypatch)
    args = make_case(kind)
    for which in ("1", "10", "128", "200", "full"):
        k = _k(args, which)
        got = port(args, k, "cuda")
        assert_same(got, port(args, k))
        assert_same(got, reference(args, k))
