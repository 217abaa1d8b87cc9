"""Kernel K7 (`ops/dense_flat.py`, `csrc/dense_flat.cu`), the dense flat
scorer's row stage, on the CPU through its plain PyTorch twin:

* the store form's twin equals, bit for bit, the row stage `flat_topk` ran
  before K7 (lane scores, then a stable descending sort of all 128 lanes),
  copied below, on the flat-scorer tests' stores (`_random_store` and the
  chunks a term batch over the Zipf fixture logs) and on every
  `kernel_cases.dense_case`;
* `flat_topk` over the twin equals the reference's `flat_topk_kernel`
  word for word on every `dense_case`;
* the cache form's twin equals the store form's where both describe the
  same rows (one denominator table, every row valid);
* K7's selection, emulated in numpy as the warp runs it (4 lanes a
  thread, each thread's lanes ordered once, then kk rounds of a max and a
  min reduction), equals the twin's order, -inf lanes included.
The `cuda` cases hold the kernel against its twin on the card, bitwise, at
kk = 1, 10 and 128. Inputs are made from seeds with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops.flat_scorer import flat_topk_kernel
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch import Term as PortTerm
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops.dense_flat import (
    cache_lanes,
    dense_flat_cache,
    dense_flat_ref,
    dense_flat_store,
    select_rows,
    store_lanes,
)
from tantivy_tpu_torch.ops.flat_scorer import flat_topk
from tantivy_tpu_torch.ops.fused_store import build_cstore_np
from tantivy_tpu_torch.query.bm25 import compute_tf_cache

from test_fused_bool import build_zipf_index
from test_torch_host_parity import port_searcher
from test_torch_term_batch import _random_store

TERMINATED = 2**31 - 1
KKS = (1, 10, 128)


def old_row_stage(cstore, rows, qid, weights, kk):
    """`flat_topk`'s row stage before K7, verbatim."""
    r = cstore[rows]                                          # [W, 384]
    docs = r[:, :128]
    tf = r[:, 128:256].float()
    cachev = r[:, 256:].view(torch.float32)
    scores = weights[qid.long()][:, None] * (tf / (tf + cachev))
    scores = torch.where(torch.isnan(cachev), float("-inf"), scores)
    row_sc, row_i = torch.sort(scores, dim=1, descending=True, stable=True)
    row_sc, row_i = row_sc[:, :kk].contiguous(), row_i[:, :kk]
    return row_sc, docs.gather(1, row_i)


def t(a):
    """numpy -> torch, u32 as int32 bits."""
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32
                                     else a))


def same(a, b):
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def store_args(case, device="cpu"):
    return tuple(t(case[key]).to(device)
                 for key in ("cstore", "rows", "qids", "weights"))


def cache_args(case, device="cpu"):
    return tuple(None if case[key] is None else t(case[key]).to(device)
                 for key in ("docs", "tfs", "valid", "qids", "norm_ids",
                             "alive", "weights", "caches"))


def random_store_chunk(seed):
    rng = np.random.default_rng(seed)
    docs, tfs, norm_ids, alive = _random_store(rng)
    cache = compute_tf_cache(np.float32(7.3))
    Q, W = 9, 300
    return dict(
        cstore=build_cstore_np(docs, tfs, norm_ids, alive, cache),
        rows=rng.integers(0, docs.shape[0], W).astype(np.int64),
        qids=rng.integers(0, Q, W).astype(np.int32),
        weights=rng.uniform(0.5, 3.0, Q + 1).astype(np.float32),
        num_queries=Q)


def zipf_chunks():
    """The flat chunks a term batch over the Zipf fixture logs (body and
    title terms in one batch)."""
    index, words = build_zipf_index()
    ex = BatchExecutor(port_searcher(index), device="cpu")
    ex.launch_log = []
    ex.search_term_batch([PortTerm.from_field_text(f, w)
                          for w in words for f in ("body", "title")], 10)
    return [rec["args"] for rec in ex.launch_log if rec["kind"] == "flat"]


@pytest.mark.parametrize("kk", KKS)
@pytest.mark.parametrize("source", ["random_0", "random_1"]
                         + [f"dense_{k}" for k in kc.DENSE_KINDS])
def test_store_twin_equals_the_old_row_stage(source, kk):
    case = (random_store_chunk(int(source[7:])) if source.startswith("random")
            else kc.dense_case(source[6:]))
    args = store_args(case)
    want = old_row_stage(*args, kk)
    got = dense_flat_ref("store", *args, kk=kk)
    assert same(got, want)
    assert same(dense_flat_store(*args, kk=kk), want)


def test_store_twin_equals_the_old_row_stage_on_zipf_chunks():
    chunks = zipf_chunks()
    assert chunks
    for cstore, rows, qids, weights, k, _ in chunks:
        for kk in KKS:
            assert same(dense_flat_store(cstore, rows, qids, weights, kk=kk),
                        old_row_stage(cstore, rows, qids, weights, kk))


@pytest.mark.parametrize("k", [1, 10, 128, 200])
@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_flat_topk_matches_reference_kernel(kind, k):
    """`flat_topk` (the store form's twin and the merge tail) against the
    reference's jitted `flat_topk_kernel` on the same rows: the packed
    [2, Q, k] outputs are equal word for word."""
    case = kc.dense_case(kind)
    p = case["parts"]
    rows, Q = case["rows"], case["num_queries"]
    alive = p["alive"] if p["alive"] is not None else np.ones(
        len(p["norm_ids"]), bool)
    want = np.asarray(flat_topk_kernel(
        jnp.asarray(p["docs"][rows]), jnp.asarray(p["tfs"][rows]),
        jnp.asarray(case["qids"]), jnp.ones(len(rows), dtype=bool),
        jnp.asarray(p["norm_ids"]), jnp.asarray(alive),
        jnp.asarray(case["weights"]),
        jnp.asarray(np.tile(p["cache"], (Q + 1, 1))), k, Q,
    ))
    got = flat_topk(*store_args(case), k, Q).numpy()
    assert got.shape == want.shape == (2, Q, k)
    assert np.array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_cache_form_equals_store_form_on_the_same_rows(kind):
    """One denominator table for every query (the store's) and every row
    valid: the two forms give the same lanes, scores and docs."""
    case = kc.dense_case(kind)
    Qp = len(case["weights"])
    same_rows = dict(case, valid=np.ones(len(case["rows"]), bool),
                     caches=np.tile(case["parts"]["cache"], (Qp, 1)))
    if same_rows["alive"] is None:
        assert case["parts"]["alive"] is None
    s_sc, s_doc = store_lanes(*store_args(case))
    c_sc, c_doc = cache_lanes(*cache_args(same_rows))
    assert same((c_sc, c_doc), (s_sc, s_doc))
    for kk in KKS:
        got = dense_flat_cache(*cache_args(same_rows), kk=kk)
        assert same(got[:2], dense_flat_store(*store_args(case), kk=kk))


@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_dense_case_holds_what_it_claims(kind):
    case = kc.dense_case(kind)
    sc, docs = store_lanes(*store_args(case))
    live = torch.isfinite(sc)
    if kind == "ties":
        # every live lane of a (non-padding) item ties
        first = sc.max(dim=1).values
        assert ((sc == first[:, None]) | ~live).all()
    if kind == "dead":
        assert (~live).all(dim=1).any()
    if kind == "sparse":
        assert (live.sum(dim=1) < 10).all()
    if kind == "invalid":
        assert (~t(case["valid"])).any()
        real = (t(case["docs"]) != TERMINATED).any(dim=1)
        assert (real & ~t(case["valid"])).any()
    if kind == "mid_pad":
        d = t(case["docs"])
        inner = (d[:, :-1] == TERMINATED) & (d[:, 1:] != TERMINATED)
        assert inner.any()
    # padding items hold real rows
    pad = t(case["qids"]) == case["num_queries"]
    assert pad.any() and (docs[pad] != TERMINATED).any()


def score_image(sc: np.ndarray) -> np.ndarray:
    """K7's `score_image`: order-keeping u32 image, both zeros one
    image."""
    u = sc.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    neg = (u & np.uint32(0x80000000)) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def k7_select(sc: np.ndarray, docs: np.ndarray, kk: int):
    """K7's selection over items [n, 128], thread t owning lanes 4t..4t+3:
    each thread orders its 4 lanes once (image desc, lane asc), then one
    round per output slot, every lane a candidate; ([n, kk] scores, docs,
    lanes)."""
    n = sc.shape[0]
    img = score_image(sc).reshape(n, 32, 4).astype(np.int64)
    i = np.arange(4)
    pos = ((img[:, :, None, :] > img[:, :, :, None])
           | ((img[:, :, None, :] == img[:, :, :, None])
              & (i[None, :] < i[:, None])[None, None])).sum(axis=3)
    order = np.zeros((n, 32, 4), np.int64)
    np.put_along_axis(order, pos, np.broadcast_to(i, (n, 32, 4)), axis=2)
    head = np.zeros((n, 32), np.int64)
    out_sc = np.zeros((n, kk), np.float32)
    out_doc = np.zeros((n, kk), np.int32)
    out_lane = np.zeros((n, kk), np.uint8)
    rows = np.arange(n)
    t_ = np.arange(32)
    for r in range(kk):
        left = head < 4
        hi = np.take_along_axis(order, np.minimum(head, 3)[:, :, None],
                                axis=2)[:, :, 0]
        mine = np.where(left, np.take_along_axis(img, hi[:, :, None],
                                                 axis=2)[:, :, 0], 0)
        mlane = np.where(left, 4 * t_[None, :] + hi, 1 << 32)
        best = mine.max(axis=1)                              # reduce max
        pick = np.where(left & (mine == best[:, None]), mlane,
                        1 << 32).min(axis=1)                 # reduce min
        out_sc[:, r] = sc[rows, pick]
        out_doc[:, r] = docs[rows, pick]
        out_lane[:, r] = pick
        head[rows, pick // 4] += 1
    return out_sc, out_doc, out_lane


@pytest.mark.parametrize("kk", KKS)
@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_warp_selection_emulation_matches_the_twin(kind, kk):
    case = kc.dense_case(kind)
    sc, docs = cache_lanes(*cache_args(case))
    got = k7_select(sc.numpy(), docs.numpy(), kk)
    want = select_rows(sc, docs, kk)
    assert np.array_equal(got[0].view(np.int32),
                          want[0].numpy().view(np.int32))
    assert np.array_equal(got[1], want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())


def test_wrapper_checks_its_inputs():
    case = kc.dense_case("ties")
    cstore, rows, qids, weights = store_args(case)
    with pytest.raises(ValueError):
        dense_flat_store(cstore, rows.int(), qids, weights, kk=10)
    with pytest.raises(ValueError):
        dense_flat_store(cstore, rows, qids, weights, kk=129)
    with pytest.raises(ValueError):
        dense_flat_store(cstore[:, :256].contiguous(), rows, qids, weights,
                         kk=10)
    args = list(cache_args(case))
    args[2] = args[2][:5]
    with pytest.raises(ValueError):
        dense_flat_cache(*args, kk=10)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_kernel_matches_twin_on_cuda(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = kc.dense_case(kind)
    for kk in KKS:
        got = dense_flat_store(*store_args(case, "cuda"), kk=kk)
        torch.cuda.synchronize()
        assert same([x.cpu() for x in got],
                    dense_flat_ref("store", *store_args(case), kk=kk))
        got = dense_flat_cache(*cache_args(case, "cuda"), kk=kk)
        assert same([x.cpu() for x in got],
                    dense_flat_ref("cache", *cache_args(case), kk=kk))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 65, 4001])
def test_kernel_on_chunks_with_a_half_empty_warp(W):
    """W items, rows and queries out of range among them: the kernel
    writes exactly the chunk's rows, bitwise the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(W)
    case = random_store_chunk(W)
    n_rows = case["cstore"].shape[0]
    case["rows"] = rng.integers(-2, n_rows + 2, W).astype(np.int64)
    case["qids"] = rng.integers(-1, 12, W).astype(np.int32)
    for kk in KKS:
        got = dense_flat_store(*store_args(case, "cuda"), kk=kk)
        assert got[0].shape == (W, kk)
        assert same([x.cpu() for x in got],
                    dense_flat_ref("store", *store_args(case), kk=kk))
