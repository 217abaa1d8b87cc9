"""Dense flat scorer (kernel K7): the CUDA kernel's wrapper and its plain
PyTorch twin.

K7 is the row stage of two XLA programs of the reference:
`term_scorer._topk_kernel` (`tantivy_tpu/ops/term_scorer.py:25-49`) and
the per-row stage of `flat_topk_kernel`
(`tantivy_tpu/ops/flat_scorer.py:43-95`): BM25 over decoded 128-lane
posting rows, then each row's top-kk lanes. The kernel source and a note on
its design are in `tantivy_tpu_torch/csrc/dense_flat.cu`.

Two input forms, per launch of W work items:
* store form (`dense_flat_store`, under `flat_scorer.flat_topk`): `cstore`
  [NB, 384] int32 fused-store rows (docs | tfs | BM25 denominator, NaN on
  deleted and padding lanes), `rows` [W] int64 store rows, `qids` [W]
  int32 and `weights` [Qp] f32;
* cache form (`dense_flat_cache`, under `term_scorer._topk_kernel`):
  `docs`, `tfs` [W, 128] int32 (u32 bits), `valid` [W] bool, `qids` [W]
  int32, `norm_ids` [max_doc] uint8, `alive` [max_doc] bool or None,
  `weights` [Qp] f32 and `caches` [Qp, 256] f32.
Output: per item its top-kk of all 128 lanes, ordered (score desc, lane
asc) as `lax.top_k` orders a row, -inf lanes included with their own docs:
scores [W, kk] f32, docs [W, kk] int32 (u32 bits) and, in the cache form,
each slot's lane [W, kk] uint8. A lane is -inf where the reference masks it
(a NaN denominator; TERMINATED, a dead doc or an invalid row), and every
lane of an item whose query lies outside the weight table, or, in the store
form, whose row lies outside the store (its docs then read TERMINATED).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED
from .decode import as_u32
from .probe_scorer import check_tensor

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: columns of a fused-store row and of a per-query denominator table
STORE_COLS = 384
CACHE_COLS = 256


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
    """Plain PyTorch version of the kernel in `form` ("store" or "cache"):
    the lane scores, then `select_rows`. Returns (scores, docs) in the
    store form and (scores, docs, lanes) in the cache form."""
    lanes = store_lanes if form == "store" else cache_lanes
    out = select_rows(*lanes(*args), kk)
    return out[:2] if form == "store" else out


def _check_common(qids, weights, kk: int, dev, W: int) -> None:
    check_tensor("qids", qids, torch.int32, 1, dev)
    check_tensor("weights", weights, torch.float32, 1, dev)
    if qids.shape[0] != W:
        raise ValueError(f"qids has {qids.shape[0]} items, not {W}")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_flat runs on cuda or cpu, not {dev}")


def dense_flat_store(cstore, rows, qids, weights, *, kk: int):
    """Score one launch chunk of the store form: (scores [W, kk] f32, docs
    [W, kk] int32). CUDA tensors launch the kernel; CPU tensors take the
    twin."""
    dev = rows.device
    check_tensor("cstore", cstore, torch.int32, 2, dev)
    check_tensor("rows", rows, torch.int64, 1, dev)
    W = rows.shape[0]
    _check_common(qids, weights, kk, dev, W)
    if cstore.shape[1] != STORE_COLS:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} columns, not "
                         f"{STORE_COLS}")
    if dev.type == "cpu":
        return dense_flat_ref("store", cstore, rows, qids, weights, kk=kk)
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().dense_flat_store_launch(
            cstore.data_ptr(), cstore.shape[0], rows.data_ptr(),
            qids.data_ptr(), W, weights.data_ptr(), weights.shape[0], kk,
            out_sc.data_ptr(), out_doc.data_ptr(), None, stream,
        )
    _counted(err)
    return out_sc, out_doc


def dense_flat_cache(docs, tfs, valid, qids, norm_ids, alive, weights,
                     caches, *, kk: int):
    """Score one launch chunk of the cache form: (scores [W, kk] f32, docs
    [W, kk] int32, lanes [W, kk] uint8). CUDA tensors launch the kernel;
    CPU tensors take the twin."""
    dev = docs.device
    check_tensor("docs", docs, torch.int32, 2, dev)
    check_tensor("tfs", tfs, torch.int32, 2, dev)
    check_tensor("valid", valid, torch.bool, 1, dev)
    check_tensor("norm_ids", norm_ids, torch.uint8, 1, dev)
    check_tensor("caches", caches, torch.float32, 2, dev)
    W, max_doc = docs.shape[0], norm_ids.shape[0]
    _check_common(qids, weights, kk, dev, W)
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
    args = (docs, tfs, valid, qids, norm_ids, alive, weights, caches)
    if dev.type == "cpu":
        return dense_flat_ref("cache", *args, kk=kk)
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    out_lane = torch.empty((W, kk), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().dense_flat_cache_launch(
            docs.data_ptr(), tfs.data_ptr(), valid.data_ptr(),
            qids.data_ptr(), W, norm_ids.data_ptr(),
            None if alive is None else alive.data_ptr(), max_doc,
            weights.data_ptr(), caches.data_ptr(), weights.shape[0], kk,
            out_sc.data_ptr(), out_doc.data_ptr(), out_lane.data_ptr(),
            stream,
        )
    _counted(err)
    return out_sc, out_doc, out_lane


def _counted(err: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"dense_flat kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        launches += 1


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("dense_flat")
    if lib.dense_flat_store_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dense_flat_store_launch.argtypes = [
            p, ll, p, p, i,        # cstore, n_rows, rows, qids, n_items
            p, i, i,               # weights, n_weights, kk
            p, p, p, p,            # out_scores, out_docs, out_lanes, stream
        ]
        lib.dense_flat_store_launch.restype = ctypes.c_int
        lib.dense_flat_cache_launch.argtypes = [
            p, p, p, p, i,         # docs, tfs, valid, qids, n_items
            p, p, i,               # norm_ids, alive, max_doc
            p, p, i, i,            # weights, caches, n_weights, kk
            p, p, p, p,            # out_scores, out_docs, out_lanes, stream
        ]
        lib.dense_flat_cache_launch.restype = ctypes.c_int
    return lib
