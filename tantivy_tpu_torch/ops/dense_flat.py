"""Dense flat scorer (kernel K7): the CUDA kernels' wrappers and their plain
PyTorch twins.

K7 is the whole of two XLA programs of the reference:
`flat_topk_kernel` (`tantivy_tpu/ops/flat_scorer.py:43-95`) and
`term_scorer._topk_kernel` (`tantivy_tpu/ops/term_scorer.py:25-49`): BM25
over decoded 128-lane posting rows, then each query's top-k. The kernel
source and a note on its design are in `tantivy_tpu_torch/csrc/dense_flat.cu`.

Two input forms, per call of W work items (one row and its query id each,
in any qid order):
* store form (`dense_flat_store`, under `flat_scorer.flat_topk`): `cstore`
  [NB, 384] int32 fused-store rows (docs | tfs | BM25 denominator, NaN on
  deleted and padding lanes), `rows` [W] int64 store rows, `qids` [W]
  int32 and `weights` [Qp] f32;
* cache form (`dense_flat_cache`, under `term_scorer._topk_kernel`):
  `docs`, `tfs` [W, 128] int32 (u32 bits), `valid` [W] bool, `qids` [W]
  int32, `norm_ids` [max_doc] uint8, `alive` [max_doc] bool or None,
  `weights` [Qp] f32 and `caches` [Qp, 256] f32.
A lane is -inf where the reference masks it (a NaN denominator;
TERMINATED, a dead doc or an invalid row), and every lane of an item whose
query lies outside the weight table, or, in the store form, whose row lies
outside the store (its docs then read TERMINATED).

Output per query q in [0, num_queries), for k <= `MAX_K`:
* store form: the packed [2, Q, k] int32 form of
  `probe_scorer.pack_results` (score bits | doc), ordered (score desc, doc
  asc as u32), -inf lanes dropped, -inf / 0 past the query's hits; no
  dedup, as `per_query_topk_from_rows`;
* cache form: (scores [Q, k] f32, docs [Q, k] int32), ordered as
  `lax.top_k` orders the query's lanes: score desc, then the flat index
  b * 128 + lane ascending (b: the item's rank among its query's items, in
  item order); -inf lanes kept with their own docs, -inf / 0 past the
  query's lanes.
Each call launches two kernels, `group` (the items grouped by query on the
card) and `select` (the per-query top-k); both count in `launches`. For k
above `MAX_K` the callers take the row stage (`dense_flat_rows_store`,
`dense_flat_rows_cache`: each row's top-kk of all 128 lanes, one launch)
and a merge (the store form's: kernel K8, `merge_tail.topk_from_rows`;
the cache form's: `cache_merge`, torch); the choice is made from k, before
any launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED
from .decode import as_u32
from .probe_scorer import (
    _lexsort2,
    _sortable_desc,
    _take_k,
    check_tensor,
    pack_results,
    per_query_topk_from_rows,
)

#: CUDA launches since the last reset (the CPU twin does not count), and
#: the same by kernel (`group`, `select`, `rows`); batches in flight on
#: several threads add to them under `_count_lock`
launches = 0
launches_by_kernel: dict[str, int] = {}
_count_lock = threading.Lock()

#: columns of a fused-store row and of a per-query denominator table
STORE_COLS = 384
CACHE_COLS = 256
#: the largest k the per-query kernels take; above it, the row stage
MAX_K = 128
#: the kernels that one call of `dense_flat_store` / `dense_flat_cache`
#: launches
KERNELS_PER_CALL = 2


def store_lanes(cstore, rows, qids, weights):
    """Plain PyTorch lane scores of the store form before its selection:
    (scores [W, 128] f32, docs [W, 128] int32)."""
    n_rows, Qp = cstore.shape[0], weights.shape[0]
    rows = rows.long()
    row_ok = (rows >= 0) & (rows < n_rows)
    r = cstore[rows.clamp(0, max(n_rows - 1, 0))]              # [W, 384]
    docs = torch.where(row_ok[:, None], r[:, :128], TERMINATED)
    tf = as_u32(r[:, 128:256]).float()
    cachev = r[:, 256:].view(torch.float32)
    q = qids.long()
    q_ok = (q >= 0) & (q < Qp)
    scores = weights[q.clamp(0, max(Qp - 1, 0))][:, None] * (
        tf / (tf + cachev))
    live = ~torch.isnan(cachev) & (row_ok & q_ok)[:, None]
    return torch.where(live, scores, float("-inf")), docs


def cache_lanes(docs, tfs, valid, qids, norm_ids, alive, weights, caches):
    """Plain PyTorch lane scores of the cache form before its selection,
    `_topk_kernel`'s scoring and masks bit for bit: (scores [W, 128] f32,
    docs [W, 128] int32)."""
    max_doc, Qp = norm_ids.shape[0], weights.shape[0]
    d = as_u32(docs)
    safe = d.clamp(max=max(max_doc - 1, 0))
    q = qids.long()
    q_ok = (q >= 0) & (q < Qp)
    qs = q.clamp(0, max(Qp - 1, 0))
    norm = caches[qs[:, None], norm_ids[safe].long()]
    tf = as_u32(tfs).float()
    scores = weights[qs][:, None] * (tf / (tf + norm))
    live = (d != TERMINATED) & (valid & q_ok)[:, None]
    if alive is not None:
        live &= alive[safe]
    return torch.where(live, scores, float("-inf")), docs


def select_rows(scores, docs, kk: int):
    """Each row's top-kk lanes by (score desc, lane asc), -inf lanes
    included: (scores [W, kk], docs [W, kk], lanes [W, kk] uint8)."""
    sc, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    idx = idx[:, :kk]
    return (sc[:, :kk].contiguous(), docs.gather(1, idx),
            idx.to(torch.uint8))


def dense_flat_ref(form: str, *args, kk: int):
    """Plain PyTorch version of the row stage in `form` ("store" or
    "cache"): the lane scores, then `select_rows`. Returns (scores, docs)
    in the store form and (scores, docs, lanes) in the cache form."""
    lanes = store_lanes if form == "store" else cache_lanes
    out = select_rows(*lanes(*args), kk)
    return out[:2] if form == "store" else out


def cache_merge(row_sc, row_doc, row_lane, qids, k: int, num_queries: int):
    """The cache form's per-query merge of [W, kk] row candidates: per
    query q in [0, num_queries) its top-k by (score desc, flat index
    b * 128 + lane asc), b the item's rank among the query's items in item
    order, -inf candidates kept; -inf / 0 past the query's candidates.
    Returns (scores [Q, k] f32, docs [Q, k] int32)."""
    W, kk = row_sc.shape
    dev = row_sc.device
    q = qids.long()
    q = torch.where((q >= 0) & (q < num_queries), q, num_queries)
    # each item's rank among its query's items, in item order
    by_q = torch.sort(q, stable=True).indices
    sq = q[by_q]
    first = torch.searchsorted(sq, sq)
    rank = torch.empty_like(by_q)
    rank[by_q] = torch.arange(W, device=dev) - first
    flat = (rank[:, None] * 128 + row_lane.long()).reshape(-1)
    scores = row_sc.reshape(-1)
    cq = q.repeat_interleave(kk)
    p = _lexsort2((cq << 32) | _sortable_desc(scores), flat)
    return _take_k(cq[p], (scores[p], row_doc.reshape(-1)[p].long()), k,
                   num_queries)


def store_topk_ref(cstore, rows, qids, weights, k: int, num_queries: int):
    """Plain PyTorch version of `dense_flat_store`: the row stage at
    kk = min(k, 128), then `per_query_topk_from_rows`, packed."""
    row_sc, row_doc = dense_flat_ref("store", cstore, rows, qids, weights,
                                     kk=min(k, MAX_K))
    return pack_results(*per_query_topk_from_rows(row_sc, row_doc, qids, k,
                                                  num_queries))


def cache_topk_ref(docs, tfs, valid, qids, norm_ids, alive, weights, caches,
                   k: int, num_queries: int):
    """Plain PyTorch version of `dense_flat_cache`: the row stage at
    kk = min(k, 128), then `cache_merge`."""
    out = dense_flat_ref("cache", docs, tfs, valid, qids, norm_ids, alive,
                         weights, caches, kk=min(k, MAX_K))
    return cache_merge(*out, qids, k, num_queries)


def _check_common(qids, weights, dev, W: int) -> None:
    check_tensor("qids", qids, torch.int32, 1, dev)
    check_tensor("weights", weights, torch.float32, 1, dev)
    if qids.shape[0] != W:
        raise ValueError(f"qids has {qids.shape[0]} items, not {W}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_flat runs on cuda or cpu, not {dev}")


def _check_store(cstore, rows, qids, weights) -> int:
    dev = rows.device
    check_tensor("cstore", cstore, torch.int32, 2, dev)
    check_tensor("rows", rows, torch.int64, 1, dev)
    W = rows.shape[0]
    _check_common(qids, weights, dev, W)
    if cstore.shape[1] != STORE_COLS:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} columns, not "
                         f"{STORE_COLS}")
    return W


def _check_cache(docs, tfs, valid, qids, norm_ids, alive, weights,
                 caches) -> int:
    dev = docs.device
    check_tensor("docs", docs, torch.int32, 2, dev)
    check_tensor("tfs", tfs, torch.int32, 2, dev)
    check_tensor("valid", valid, torch.bool, 1, dev)
    check_tensor("norm_ids", norm_ids, torch.uint8, 1, dev)
    check_tensor("caches", caches, torch.float32, 2, dev)
    W, max_doc = docs.shape[0], norm_ids.shape[0]
    _check_common(qids, weights, dev, W)
    if alive is not None:
        check_tensor("alive", alive, torch.bool, 1, dev)
        if alive.shape[0] != max_doc:
            raise ValueError(f"alive has {alive.shape[0]} docs, norm_ids "
                             f"{max_doc}")
    if docs.shape[1] != 128 or tuple(tfs.shape) != tuple(docs.shape):
        raise ValueError(f"docs {tuple(docs.shape)} and tfs "
                         f"{tuple(tfs.shape)} must both be [W, 128]")
    if valid.shape[0] != W:
        raise ValueError(f"valid has {valid.shape[0]} rows, not {W}")
    if tuple(caches.shape) != (weights.shape[0], CACHE_COLS):
        raise ValueError(f"caches shape {tuple(caches.shape)} != "
                         f"{(weights.shape[0], CACHE_COLS)}")
    if max_doc < 1:
        raise ValueError("norm_ids must hold at least one doc")
    return W


def _check_topk(k: int, num_queries: int, W: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}; larger k takes the "
                         "row stage")
    if num_queries < 1:
        raise ValueError(f"num_queries={num_queries} must be at least 1")
    if W >= 1 << 25:
        raise ValueError(f"{W} items: the flat index b * 128 + lane must "
                         "fit 32 bits")


def dense_flat_store(cstore, rows, qids, weights, *, k: int,
                     num_queries: int):
    """Each query's top-k over one chunk of store-form items: packed
    [2, Q, k] int32. CUDA tensors launch the group and select kernels; CPU
    tensors take the twin (`store_topk_ref`)."""
    W = _check_store(cstore, rows, qids, weights)
    _check_topk(k, num_queries, W)
    dev = rows.device
    if dev.type == "cpu":
        return store_topk_ref(cstore, rows, qids, weights, k, num_queries)
    lib = _lib()
    out = torch.empty((2, num_queries, k), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, W, num_queries, k, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _counted(lib.dense_flat_group_launch(
            qids.data_ptr(), W, num_queries, k, scratch.data_ptr(), stream,
        ), "group")
        _counted(lib.dense_flat_select_store_launch(
            cstore.data_ptr(), cstore.shape[0], rows.data_ptr(), W,
            weights.data_ptr(), weights.shape[0], num_queries, k,
            scratch.data_ptr(), out.data_ptr(), stream,
        ), "select")
    return out


def dense_flat_cache(docs, tfs, valid, qids, norm_ids, alive, weights,
                     caches, *, k: int, num_queries: int):
    """Each query's top-k over one chunk of cache-form items: (scores
    [Q, k] f32, docs [Q, k] int32). CUDA tensors launch the group and
    select kernels; CPU tensors take the twin (`cache_topk_ref`)."""
    args = (docs, tfs, valid, qids, norm_ids, alive, weights, caches)
    W = _check_cache(*args)
    _check_topk(k, num_queries, W)
    dev = docs.device
    if dev.type == "cpu":
        return cache_topk_ref(*args, k, num_queries)
    lib = _lib()
    out_sc = torch.empty((num_queries, k), dtype=torch.float32, device=dev)
    out_doc = torch.empty((num_queries, k), dtype=torch.int32, device=dev)
    scratch = _scratch(lib, W, num_queries, k, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _counted(lib.dense_flat_group_launch(
            qids.data_ptr(), W, num_queries, k, scratch.data_ptr(), stream,
        ), "group")
        _counted(lib.dense_flat_select_cache_launch(
            docs.data_ptr(), tfs.data_ptr(), valid.data_ptr(), W,
            norm_ids.data_ptr(), None if alive is None else alive.data_ptr(),
            norm_ids.shape[0], weights.data_ptr(), caches.data_ptr(),
            weights.shape[0], num_queries, k, scratch.data_ptr(),
            out_sc.data_ptr(), out_doc.data_ptr(), stream,
        ), "select")
    return out_sc, out_doc


def dense_flat_rows_store(cstore, rows, qids, weights, *, kk: int):
    """The row stage over one chunk of store-form items: each item's top-kk
    of its 128 lanes by (score desc, lane asc), -inf lanes included:
    (scores [W, kk] f32, docs [W, kk] int32). CUDA tensors launch the row
    kernel; CPU tensors take the twin."""
    W = _check_store(cstore, rows, qids, weights)
    _check_kk(kk)
    dev = rows.device
    if dev.type == "cpu":
        return dense_flat_ref("store", cstore, rows, qids, weights, kk=kk)
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _counted(_lib().dense_flat_store_launch(
            cstore.data_ptr(), cstore.shape[0], rows.data_ptr(),
            qids.data_ptr(), W, weights.data_ptr(), weights.shape[0], kk,
            out_sc.data_ptr(), out_doc.data_ptr(), None, stream,
        ), "rows")
    return out_sc, out_doc


def dense_flat_rows_cache(docs, tfs, valid, qids, norm_ids, alive, weights,
                          caches, *, kk: int):
    """The row stage over one chunk of cache-form items: (scores [W, kk]
    f32, docs [W, kk] int32, lanes [W, kk] uint8). CUDA tensors launch the
    row kernel; CPU tensors take the twin."""
    args = (docs, tfs, valid, qids, norm_ids, alive, weights, caches)
    W = _check_cache(*args)
    _check_kk(kk)
    dev = docs.device
    if dev.type == "cpu":
        return dense_flat_ref("cache", *args, kk=kk)
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    out_lane = torch.empty((W, kk), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _counted(_lib().dense_flat_cache_launch(
            docs.data_ptr(), tfs.data_ptr(), valid.data_ptr(),
            qids.data_ptr(), W, norm_ids.data_ptr(),
            None if alive is None else alive.data_ptr(), norm_ids.shape[0],
            weights.data_ptr(), caches.data_ptr(), weights.shape[0], kk,
            out_sc.data_ptr(), out_doc.data_ptr(), out_lane.data_ptr(),
            stream,
        ), "rows")
    return out_sc, out_doc, out_lane


def _check_kk(kk: int) -> None:
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")


def _scratch(lib, W: int, num_queries: int, k: int, dev):
    """The group and select kernels' scratch for one call (uninitialised:
    the group kernel writes what the select kernel reads)."""
    n = lib.dense_flat_scratch_bytes(W, num_queries, k)
    return torch.empty(n, dtype=torch.uint8, device=dev)


def reset_counts() -> None:
    """Set `launches` and `launches_by_kernel` to zero."""
    global launches
    with _count_lock:
        launches = 0
        launches_by_kernel.clear()


def _counted(err: int, kernel: str) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"dense_flat {kernel} kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        launches += 1
        launches_by_kernel[kernel] = launches_by_kernel.get(kernel, 0) + 1


def signatures() -> dict:
    """Each C entry point's ctypes (argtypes, restype)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return {
        "dense_flat_scratch_bytes": ([i, i, i], ll),
        "dense_flat_group_launch": ([
            p, i, i, i,            # qids, n_items, num_queries, k
            p, p,                  # scratch, stream
        ], ctypes.c_int),
        "dense_flat_select_store_launch": ([
            p, ll, p, i,           # cstore, n_rows, rows, n_items
            p, i, i, i,            # weights, n_weights, num_queries, k
            p, p, p,               # scratch, out, stream
        ], ctypes.c_int),
        "dense_flat_select_cache_launch": ([
            p, p, p, i,            # docs, tfs, valid, n_items
            p, p, i,               # norm_ids, alive, max_doc
            p, p, i, i, i,         # weights, caches, n_weights, Q, k
            p, p, p, p,            # scratch, out_scores, out_docs, stream
        ], ctypes.c_int),
        "dense_flat_store_launch": ([
            p, ll, p, p, i,        # cstore, n_rows, rows, qids, n_items
            p, i, i,               # weights, n_weights, kk
            p, p, p, p,            # out_scores, out_docs, out_lanes, stream
        ], ctypes.c_int),
        "dense_flat_cache_launch": ([
            p, p, p, p, i,         # docs, tfs, valid, qids, n_items
            p, p, i,               # norm_ids, alive, max_doc
            p, p, i, i,            # weights, caches, n_weights, kk
            p, p, p, p,            # out_scores, out_docs, out_lanes, stream
        ], ctypes.c_int),
    }


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("dense_flat")
    if lib.dense_flat_scratch_bytes.argtypes is None:
        for name, (args, res) in signatures().items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib
