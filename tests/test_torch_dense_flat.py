"""Kernel K7 (`ops/dense_flat.py`, `csrc/dense_flat.cu`), the dense flat
scorer, on the CPU through its plain PyTorch twins:

* the row stage's twin (the route for k > 128) equals, bit for bit, the
  row stage `flat_topk` ran before K7 (lane scores, then a stable
  descending sort of all 128 lanes), copied below, on the flat-scorer
  tests' stores (`_random_store` and the chunks a term batch over the Zipf
  fixture logs) and on every `kernel_cases.dense_case`;
* `flat_topk` (K7's store form for k <= 128, the row stage and the merge
  tail above) and `dense_flat_store` itself equal the reference's
  `flat_topk_kernel` word for word on every `dense_case`, at k = 1, 10,
  128 and 200;
* the work-list cases: items in shuffled qid order, a row repeated for one
  query, a query whose lanes are all -inf, qids outside the table;
* the cache form's twin equals the store form's where both describe the
  same rows (one denominator table, every row valid);
* the per-query kernels' algorithm, emulated in numpy as the card runs it
  (the group pass, tiles of 16 items, the row pre-threshold while a list
  is short, the threshold ballot against the tile's and the query's
  shared k-th key, the gathered batch merges, the
  tile lists and the last tile's merge), equals the twins, in both forms,
  whatever order the scatter leaves a query's items in and whatever order
  its tiles' rows run in;
* the row stage's selection, emulated in numpy as the warp runs it (4
  lanes a thread, each thread's lanes ordered once, then kk rounds of a
  max and a min reduction), equals the twin's order, -inf lanes included.
The `cuda` cases hold the kernels against their twins on the card,
bitwise, at k = 1, 10 and 128, on chunks whose tiles split one query and
end half empty, and show that the k <= 128 route runs no torch sort.
Inputs are made from seeds with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops.flat_scorer import flat_topk_kernel
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch import Term as PortTerm
from tantivy_tpu_torch.ops import dense_flat as df
from tantivy_tpu_torch.ops import flat_scorer, probe_scorer
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops.dense_flat import (
    cache_lanes,
    cache_topk_ref,
    dense_flat_cache,
    dense_flat_ref,
    dense_flat_rows_cache,
    dense_flat_rows_store,
    dense_flat_store,
    select_rows,
    store_lanes,
    store_topk_ref,
)
from tantivy_tpu_torch.ops.flat_scorer import flat_topk
from tantivy_tpu_torch.ops.fused_store import build_cstore_np
from tantivy_tpu_torch.ops.term_scorer import _topk_kernel
from tantivy_tpu_torch.query.bm25 import compute_tf_cache

from test_fused_bool import build_zipf_index
from test_torch_host_parity import port_searcher
from test_torch_term_batch import _random_store

TERMINATED = 2**31 - 1
KKS = (1, 10, 128)
#: the per-query kernels' tile: one item a lane of a warp
TILE_ROWS = 16


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


def random_store_chunk(seed, Q=9, W=300):
    rng = np.random.default_rng(seed)
    docs, tfs, norm_ids, alive = _random_store(rng)
    cache = compute_tf_cache(np.float32(7.3))
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


def reference_flat(case, rows, qids, k):
    """The reference's jitted `flat_topk_kernel` over the case's store
    rows `rows` with query ids `qids` (all in range), as u32 [2, Q, k]."""
    p = case["parts"]
    Q = case["num_queries"]
    alive = p["alive"] if p["alive"] is not None else np.ones(
        len(p["norm_ids"]), bool)
    return np.asarray(flat_topk_kernel(
        jnp.asarray(p["docs"][rows]), jnp.asarray(p["tfs"][rows]),
        jnp.asarray(qids), jnp.ones(len(rows), dtype=bool),
        jnp.asarray(p["norm_ids"]), jnp.asarray(alive),
        jnp.asarray(case["weights"]),
        jnp.asarray(np.tile(p["cache"], (Q + 1, 1))), k, Q,
    ))


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
    assert same(dense_flat_rows_store(*args, kk=kk), want)


def test_store_twin_equals_the_old_row_stage_on_zipf_chunks():
    chunks = zipf_chunks()
    assert chunks
    for cstore, rows, qids, weights, k, Q in chunks:
        for kk in KKS:
            want = old_row_stage(cstore, rows, qids, weights, kk)
            assert same(dense_flat_rows_store(cstore, rows, qids, weights,
                                              kk=kk), want)
        # and the per-query twin is the old row stage and the merge tail
        assert torch.equal(
            dense_flat_store(cstore, rows, qids, weights, k=k,
                             num_queries=Q),
            probe_scorer.pack_results(*probe_scorer.per_query_topk_from_rows(
                *old_row_stage(cstore, rows, qids, weights, k), qids, k, Q)))


@pytest.mark.parametrize("k", [1, 10, 128, 200])
@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_flat_topk_matches_reference_kernel(kind, k):
    """`flat_topk` (K7's store form for k <= 128, the row stage and the
    merge tail above) against the reference's jitted `flat_topk_kernel` on
    the same rows: the packed [2, Q, k] outputs are equal word for word;
    so is `dense_flat_store` itself where it takes k."""
    case = kc.dense_case(kind)
    Q = case["num_queries"]
    want = reference_flat(case, case["rows"], case["qids"], k)
    got = flat_topk(*store_args(case), k, Q).numpy()
    assert got.shape == want.shape == (2, Q, k)
    assert np.array_equal(got.view(np.uint32), want)
    if k <= df.MAX_K:
        got = dense_flat_store(*store_args(case), k=k, num_queries=Q)
        assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("kind", ["ties", "mid_pad", "sparse"])
def test_shuffled_qid_order_matches_reference(kind, k):
    """Items in shuffled qid order: the same per-query top-k as the
    reference on the shuffled list, and as on the list in order."""
    case = kc.dense_case(kind)
    Q = case["num_queries"]
    perm = np.random.default_rng(k).permutation(len(case["rows"]))
    shuffled = dict(case, rows=case["rows"][perm], qids=case["qids"][perm])
    want = reference_flat(shuffled, shuffled["rows"], shuffled["qids"], k)
    got = dense_flat_store(*store_args(shuffled), k=k, num_queries=Q)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(got, dense_flat_store(*store_args(case), k=k,
                                             num_queries=Q))


def test_repeated_row_reports_its_docs_again():
    """One row three times for one query: no dedup, as the reference."""
    case = kc.dense_case("no_alive")
    Q = case["num_queries"]
    rows = np.array([5, 5, 5, 7], np.int64)
    qids = np.array([2, 2, 2, 1], np.int32)
    one = dict(case, rows=rows, qids=qids)
    for k in KKS:
        want = reference_flat(case, rows, qids, k)
        got = dense_flat_store(*store_args(one), k=k, num_queries=Q).numpy()
        assert np.array_equal(got.view(np.uint32), want)
        live = np.isfinite(got[0, 2].view(np.float32))
        docs = got[1, 2][live]
        if k >= 3:
            # the best doc of the row, three times in a row
            assert docs[0] == docs[1] == docs[2]


def test_all_inf_query_and_qids_outside_the_table():
    """A query whose rows are all dead or outside the store gets -inf / 0
    in every slot; items of qids outside [0, Q), and of queries outside the
    weight table, give nothing; the result equals the twin's and, for the
    items in range, the reference's."""
    case = kc.dense_case("dead")
    Q, n_rows = case["num_queries"], case["cstore"].shape[0]
    rows = np.array([1, n_rows, -3, 4, 6, 2, 8, 9, 0], np.int64)
    qids = np.array([0, 0, 0, -1, Q, Q + 5, 3, 3, 2], np.int32)
    weights = case["weights"][:Q - 1]   # query Q - 1 outside the table
    rows = np.append(rows, 10)
    qids = np.append(qids, Q - 1).astype(np.int32)
    odd = dict(case, rows=rows, qids=qids, weights=weights)
    in_table = (qids >= 0) & (qids < Q - 1) & (rows >= 0) & (rows < n_rows)
    for k in KKS:
        got = dense_flat_store(*store_args(odd), k=k, num_queries=Q)
        assert torch.equal(got, store_topk_ref(*store_args(odd), k, Q))
        sc = got[0].view(torch.float32)
        assert (sc[0] == float("-inf")).all() and (got[1, 0] == 0).all()
        assert (sc[Q - 1] == float("-inf")).all()
        want = reference_flat(case, rows[in_table], qids[in_table], k)
        assert np.array_equal(got.numpy()[:, :Q - 1].view(np.uint32),
                              want[:, :Q - 1])


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
        got = dense_flat_rows_cache(*cache_args(same_rows), kk=kk)
        assert same(got[:2], dense_flat_rows_store(*store_args(case), kk=kk))


@pytest.mark.parametrize("k", [10, 200])
def test_smoke_bound_counts_only_the_functions_bytes(k):
    """The smoke's byte counts for K7 (`chip_smoke.dense_flat_bytes`,
    `dense_cache_bytes`) are the bytes the function needs, counted here
    from the chunk itself: each distinct row once, 12 bytes an item in the
    store form (row and qid) and 1,025 a row in the cache form (docs, tfs,
    valid byte, no qid), the distinct queries' weights (and tables), and
    the output. Nothing of K7's own grouping is counted, and neither the
    items' order nor a repeated item's row changes more than the item's
    own bytes."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    c = random_store_chunk(k)
    Q, W = c["num_queries"], len(c["rows"])
    args = (*store_args(c), k, Q)
    n_rows, n_q = len(np.unique(c["rows"])), len(np.unique(c["qids"]))
    out = Q * k * 8 if k <= df.MAX_K else W * df.MAX_K * 8
    want = n_rows * 1536 + 12 * W + 4 * n_q + out
    assert chip_smoke.dense_flat_bytes(args) == want
    perm = np.random.default_rng(k).permutation(W)
    shuffled = dict(c, rows=c["rows"][perm], qids=c["qids"][perm])
    assert chip_smoke.dense_flat_bytes(
        (*store_args(shuffled), k, Q)) == want
    again = dict(c, rows=np.append(c["rows"], c["rows"][0]),
                 qids=np.append(c["qids"], c["qids"][0]))
    grow = 12 if k <= df.MAX_K else 12 + df.MAX_K * 8
    assert chip_smoke.dense_flat_bytes(
        (*store_args(again), k, Q)) == want + grow

    case = kc.dense_case(kc.DENSE_KINDS[0])
    cargs = cache_args(case)
    docs = case["docs"]
    real = docs[docs != TERMINATED]
    n_q = len(np.unique(case["qids"]))
    Qc = case["num_queries"]
    out = Qc * k * 8 if k <= df.MAX_K else len(docs) * df.MAX_K * 9
    want = (len(docs) * 1025
            + len(np.unique(real)) * (1 + (case["alive"] is not None))
            + n_q * (4 + 4 * case["caches"].shape[1]) + out)
    assert chip_smoke.dense_cache_bytes(cargs, k, Qc) == want


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


def merge_batch(lst, batch, k):
    """The select kernel's `Running.merge`: `lst` a list of (key, score bits,
    doc), best first; `batch` (lane, entry) candidates, at most one a lane.
    Places each candidate by its rank in the list (entries at or above it)
    plus its rank in the batch (higher keys, equal keys of lower lanes),
    and each entry by its place plus the candidates above it; returns the
    first k."""
    keys = [e[0] for e in lst]
    out = [None] * (len(lst) + len(batch))
    rls = []
    for lane, e in batch:
        rl = sum(key >= e[0] for key in keys)
        rc = sum(f[0] > e[0] or (f[0] == e[0] and u < lane)
                 for u, f in batch)
        rls.append(rl)
        assert out[rl + rc] is None
        out[rl + rc] = e
    for j, e in enumerate(lst):
        p = j + sum(rl <= j for rl in rls)
        assert out[p] is None
        out[p] = e
    return out[:k]


def _beats(key, lst, k, shared):
    """The select kernel's test: above the query's shared k-th key and,
    once the list is full, above its k-th entry."""
    return key > shared and (len(lst) < k or key > lst[-1][0])


def insert4(lst, slots, k, shared):
    """The select kernel's `insert4`: `slots` holds, per lane slot i, the
    (lane, entry) candidates of that slot. At most 32 in all merge in one
    batch, gathered slot by slot, lanes ascending; more merge a slot at a
    time, each slot tested again against the risen threshold."""
    gathered = [e for slot in slots for _, e in slot]
    if not gathered:
        return lst
    if len(gathered) <= 32:
        return merge_batch(lst, list(enumerate(gathered)), k)
    for slot in slots:
        batch = [(u, e) for u, e in slot if _beats(e[0], lst, k, shared)]
        if batch:
            lst = merge_batch(lst, batch, k)
    return lst


def k7_emulate(form, sc, docs, qids, num_queries, k, seed=0):
    """The per-query kernels on [W, 128] lane scores and docs (the twin's
    `store_lanes` / `cache_lanes`, which the kernel computes bit for bit):
    the group pass (each query's items scattered in an order drawn from
    `seed`, as warps' atomics may leave them), tiles of TILE_ROWS items
    whose rows run in an interleaving drawn from `seed`, as concurrent
    warps may run them; per row, while the list is short (k <= 32), only
    lanes at or above the k-th best of the threads' best candidates, then
    the threshold test (the tile's k-th key and the best k-th key any tile
    of the query has published) and `insert4`, a list per tile, and the
    last tile's merge of all its
    query's lists, 128 entries a step, entry e0 + lane + 32 i in lane slot
    i. Returns (scores [Q, k] f32, docs [Q, k] i32)."""
    rng = np.random.default_rng(seed)
    img = score_image(sc).astype(np.uint64)
    lane = np.arange(128, dtype=np.uint64)
    out_sc = np.full((num_queries, k), -np.inf, np.float32)
    out_doc = np.zeros((num_queries, k), np.int32)
    for q in range(num_queries):
        items = np.flatnonzero(qids == q)
        items = items[rng.permutation(len(items))]
        tiles = [list(items[j:j + TILE_ROWS])
                 for j in range(0, max(len(items), 1), TILE_ROWS)]
        nt = len(tiles)
        lists = [[] for _ in tiles]
        shared = 0
        turns = [t for t, tile in enumerate(tiles) for _ in tile]
        rng.shuffle(turns)
        for t in turns:
            item = tiles[t].pop(0)
            tie = (docs[item].view(np.uint32).astype(np.uint64)
                   if form == "store"
                   else np.uint64(item) * np.uint64(128) + lane)
            keys = (img[item] << np.uint64(32)) | (
                ~tie & np.uint64(0xFFFFFFFF))
            cand = (np.ones(128, bool) if form == "cache"
                    else sc[item] != -np.inf)
            lst = lists[t]
            if len(lst) < k <= 32:
                # the k-th best of the 32 threads' best candidate images
                best = np.where(cand, img[item], 0).reshape(32, 4).max(1)
                t0 = np.sort(best)[::-1][k - 1]
                cand = cand & (img[item] >= t0)
            slots = [[(lt, (int(keys[4 * lt + i]), sc[item, 4 * lt + i],
                            docs[item, 4 * lt + i]))
                      for lt in range(32)
                      if cand[4 * lt + i]
                      and _beats(int(keys[4 * lt + i]), lst, k, shared)]
                     for i in range(4)]
            lst = lists[t] = insert4(lst, slots, k, shared)
            if nt > 1 and len(lst) == k:
                shared = max(shared, lst[-1][0])
        lst = lists[0]
        if nt > 1:
            # every tile's list, padded to k with empty (key 0) entries
            flat = [e for part in lists
                    for e in part + [(0, 0.0, 0)] * (k - len(part))]
            lst = []
            for e0 in range(0, len(flat), 128):
                step = flat[e0:e0 + 128]
                slots = [[(u, step[u + 32 * i]) for u in range(32)
                          if u + 32 * i < len(step)
                          and step[u + 32 * i][0] != 0
                          and _beats(step[u + 32 * i][0], lst, k, 0)]
                         for i in range(4)]
                lst = insert4(lst, slots, k, 0)
        for j, (_, s, d) in enumerate(lst):
            out_sc[q, j], out_doc[q, j] = s, d
    return out_sc, out_doc


def emulation_cases():
    """(name, form, lane scores, docs, qids, Q): every dense_case in both
    forms, and random chunks whose queries span several tiles."""
    out = []
    for kind in kc.DENSE_KINDS:
        case = kc.dense_case(kind)
        Q = case["num_queries"]
        out.append((f"{kind}-store", "store", store_args(case), Q))
        out.append((f"{kind}-cache", "cache", cache_args(case), Q))
    for seed in (0, 1):
        case = random_store_chunk(seed, Q=4, W=150)   # ~37 items a query
        out.append((f"random_{seed}-store", "store", store_args(case), 4))
    return out


EMULATION = {name: (form, args, Q) for name, form, args, Q in
             emulation_cases()}


@pytest.mark.parametrize("k", KKS)
@pytest.mark.parametrize("name", sorted(EMULATION))
def test_per_query_kernel_emulation_matches_the_twin(name, k):
    form, args, Q = EMULATION[name]
    lanes = store_lanes if form == "store" else cache_lanes
    sc, docs = (x.numpy() for x in lanes(*args))
    qids = args[2 if form == "store" else 3].numpy()
    if name.startswith("random"):
        counts = np.bincount(qids, minlength=Q)
        assert (counts > TILE_ROWS).any() and (counts % TILE_ROWS).any()
    for seed in (0, 1, 2):
        got = k7_emulate(form, sc, docs, qids, Q, k, seed)
        if form == "store":
            want = store_topk_ref(*args, k, Q)
            want = (want[0].view(torch.float32), want[1])
        else:
            want = cache_topk_ref(*args, k, Q)
        assert np.array_equal(got[0].view(np.int32),
                              want[0].numpy().view(np.int32))
        assert np.array_equal(got[1], want[1].numpy())


def k7_select(sc: np.ndarray, docs: np.ndarray, kk: int):
    """The row stage's selection over items [n, 128], thread t owning lanes
    4t..4t+3: each thread orders its 4 lanes once (image desc, lane asc),
    then one round per output slot, every lane a candidate; ([n, kk]
    scores, docs, lanes)."""
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
    Q = case["num_queries"]
    cstore, rows, qids, weights = store_args(case)
    with pytest.raises(ValueError):
        dense_flat_store(cstore, rows.int(), qids, weights, k=10,
                         num_queries=Q)
    with pytest.raises(ValueError):
        dense_flat_store(cstore, rows, qids, weights, k=129, num_queries=Q)
    with pytest.raises(ValueError):
        dense_flat_store(cstore, rows, qids, weights, k=10, num_queries=0)
    with pytest.raises(ValueError):
        dense_flat_rows_store(cstore, rows, qids, weights, kk=129)
    with pytest.raises(ValueError):
        dense_flat_rows_store(cstore[:, :256].contiguous(), rows, qids,
                              weights, kk=10)
    args = list(cache_args(case))
    with pytest.raises(ValueError):
        dense_flat_cache(*args, k=0, num_queries=Q)
    args[2] = args[2][:5]
    with pytest.raises(ValueError):
        dense_flat_cache(*args, k=10, num_queries=Q)
    with pytest.raises(ValueError):
        dense_flat_rows_cache(*args, kk=10)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", kc.DENSE_KINDS)
def test_kernel_matches_twin_on_cuda(kind):
    _cuda()
    case = kc.dense_case(kind)
    Q = case["num_queries"]
    for k in KKS:
        got = dense_flat_store(*store_args(case, "cuda"), k=k, num_queries=Q)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), store_topk_ref(*store_args(case), k, Q))
        got = dense_flat_cache(*cache_args(case, "cuda"), k=k, num_queries=Q)
        assert same([x.cpu() for x in got],
                    cache_topk_ref(*cache_args(case), k, Q))
        # the row stage, the route for k > 128
        got = dense_flat_rows_store(*store_args(case, "cuda"), kk=k)
        assert same([x.cpu() for x in got],
                    dense_flat_ref("store", *store_args(case), kk=k))
        got = dense_flat_rows_cache(*cache_args(case, "cuda"), kk=k)
        assert same([x.cpu() for x in got],
                    dense_flat_ref("cache", *cache_args(case), kk=k))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 65, 4001])
def test_kernel_on_chunks_with_a_half_empty_warp(W):
    """W items, rows and queries out of range among them, queries of many
    tiles and of none: the kernels write exactly the chunk's outputs,
    bitwise the twin's."""
    _cuda()
    rng = np.random.default_rng(W)
    Q = 12
    case = random_store_chunk(W, Q=Q, W=W)
    n_rows = case["cstore"].shape[0]
    case["rows"] = rng.integers(-2, n_rows + 2, W).astype(np.int64)
    case["qids"] = rng.integers(-1, Q + 2, W).astype(np.int32)
    for k in KKS:
        got = dense_flat_store(*store_args(case, "cuda"), k=k, num_queries=Q)
        assert got.shape == (2, Q, k)
        assert torch.equal(got.cpu(), store_topk_ref(*store_args(case), k, Q))
        got = dense_flat_rows_store(*store_args(case, "cuda"), kk=k)
        assert got[0].shape == (W, k)
        assert same([x.cpu() for x in got],
                    dense_flat_ref("store", *store_args(case), kk=k))


@pytest.mark.cuda
@pytest.mark.parametrize("n_items", [31, 32, 33, 64, 97, 3000])
def test_tiles_that_split_one_query_on_cuda(n_items):
    """One query's items over several tiles (the last one part full), the
    other queries' items shuffled among them: the last tile's merge gives
    the twin's top-k in both forms."""
    _cuda()
    rng = np.random.default_rng(n_items)
    case = random_store_chunk(n_items, Q=3, W=n_items + 20)
    qids = case["qids"]
    qids[:n_items] = 1
    perm = rng.permutation(len(qids))
    case["rows"], case["qids"] = case["rows"][perm], qids[perm]
    for k in KKS:
        got = dense_flat_store(*store_args(case, "cuda"), k=k, num_queries=3)
        assert torch.equal(got.cpu(), store_topk_ref(*store_args(case), k, 3))
    docs, tfs = (t(case["cstore"][case["rows"], c:c + 128])
                 for c in (0, 128))
    W = len(case["rows"])
    cache = (docs, tfs, torch.from_numpy(rng.random(W) < 0.9),
             t(case["qids"]), torch.from_numpy(
                 rng.integers(0, 256, 5000).astype(np.uint8)),
             torch.from_numpy(rng.random(5000) < 0.8),
             t(case["weights"]), torch.from_numpy(np.stack(
                 [compute_tf_cache(np.float32(a))
                  for a in rng.uniform(5, 60, 4)])))
    for k in KKS:
        got = dense_flat_cache(*(x.cuda() for x in cache), k=k,
                               num_queries=3)
        assert same([x.cpu() for x in got], cache_topk_ref(*cache, k, 3))


@pytest.mark.cuda
def test_k_up_to_128_runs_no_torch_sort_on_cuda(monkeypatch):
    """On the card, `flat_topk` and `_topk_kernel` at k <= 128 run K7 alone:
    with torch.sort, `_lexsort2`, `per_query_topk_from_rows` and the
    merge tail (`topk_from_rows`) made to raise they still give the twin's
    result; the launch counter grows by two kernels a call."""
    _cuda()
    case = kc.dense_case("mid_pad")
    Q = case["num_queries"]
    want = {k: (store_topk_ref(*store_args(case), k, Q),
                cache_topk_ref(*cache_args(case), k, Q)) for k in KKS}
    docs, tfs, valid, _, norm_ids, alive, _, _ = cache_args(case)
    B = 4
    Qc = docs.shape[0] // B
    reg = (docs.view(Qc, B, 128), tfs.view(Qc, B, 128), valid.view(Qc, B),
           norm_ids, t(np.resize(case["weights"], Qc)),
           t(np.resize(case["caches"], (Qc, 256))), alive)
    reg_want = {k: _topk_kernel(*reg, k) for k in KKS}

    def boom(*a, **kw):
        raise AssertionError("a torch sort ran on the k <= 128 route")

    monkeypatch.setattr(torch, "sort", boom)
    monkeypatch.setattr(probe_scorer, "_lexsort2", boom)
    monkeypatch.setattr(flat_scorer, "topk_from_rows", boom)
    monkeypatch.setattr(df, "per_query_topk_from_rows", boom)
    for k in KKS:
        n0 = df.launches
        got = flat_topk(*store_args(case, "cuda"), k, Q)
        assert df.launches - n0 == df.KERNELS_PER_CALL
        assert torch.equal(got.cpu(), want[k][0])
        got = _topk_kernel(*(None if x is None else x.cuda() for x in reg), k)
        assert same([x.cpu() for x in got], reg_want[k])
