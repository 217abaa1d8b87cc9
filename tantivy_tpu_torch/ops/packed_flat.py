"""Packed flat scorer (kernel K5): the CUDA kernel's wrapper, its plain
PyTorch twin and the per-chunk merge.

K5 replaces two XLA programs of the reference's packed mode, fused: the
bit-width decode `decode_doc_rows` / `decode_tf_rows`
(`tantivy_tpu/ops/decode.py:58-70`) and the per-row stage of
`flat_topk_kernel` (`tantivy_tpu/ops/flat_scorer.py:43-95`). The kernel
source and a note on its design are in `tantivy_tpu_torch/csrc/packed_flat.cu`.

Inputs, per launch chunk of W work items of one (segment, field):
* the mirror's tensors (`device_index.PackedMirror`): `doc_words`,
  `tf_words` [N] int32, `blk_tab` [NB, 8] int32, `norm_ids` [max_doc]
  uint8, `alive` [max_doc] bool;
* `blocks` [W] int32 block ids and `qids` [W] int32 query of each item
  (an item with qid outside [0, num_queries) is padding);
* `weights` [Qp] f32 and `caches` [Qp, 256] f32: each query's BM25 weight
  and its tf-denominator table by field-norm id.
Output: per item its top-kk lanes, scores [W, kk] f32 and docs [W, kk]
int32 (u32 bits), ordered (score desc, lane asc) as `lax.top_k` orders a
row; -inf / TERMINATED past the item's live lanes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED
from .decode import as_u32, decode_blocks
from .device_index import TAB_COLS
from .merge_tail import topk_from_rows
from .probe_scorer import check_tensor, group_topk

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: columns of the per-query denominator table (one per field-norm id)
CACHE_COLS = 256


def packed_flat_lanes(doc_words, tf_words, blk_tab, norm_ids, alive, blocks,
                      qids, weights, caches, *, num_queries: int):
    """Plain PyTorch lane scores of the kernel, before its selection: the
    reference's decode and the scoring stage of `flat_topk_kernel`, bit for
    bit (-inf on dead, deleted and padding lanes and on padding items).
    Returns (scores [W, 128] f32, docs [W, 128] int32)."""
    nb = blk_tab.shape[0]
    max_doc = norm_ids.shape[0]
    valid = (qids >= 0) & (qids < num_queries) & (blocks >= 0) & (blocks < nb)
    docs, tfs = decode_blocks(doc_words, tf_words, blk_tab,
                              blocks.long().clamp(0, max(nb - 1, 0)))
    d = as_u32(docs)
    safe = d.clamp(max=max(max_doc - 1, 0))
    q = qids.long().clamp(0, weights.shape[0] - 1)
    norm = caches[q[:, None], norm_ids[safe].long()]
    tf = as_u32(tfs).float()
    scores = weights[q][:, None] * (tf / (tf + norm))
    live = (d != TERMINATED) & valid[:, None] & alive[safe]
    return torch.where(live, scores, float("-inf")), docs


def packed_flat_ref(doc_words, tf_words, blk_tab, norm_ids, alive, blocks,
                    qids, weights, caches, *, num_queries: int, kk: int):
    """Plain PyTorch version of the kernel: `packed_flat_lanes`, then each
    item's top-kk live lanes by (score desc, lane asc)."""
    sc, docs = packed_flat_lanes(doc_words, tf_words, blk_tab, norm_ids,
                                 alive, blocks, qids, weights, caches,
                                 num_queries=num_queries)
    th = torch.full((sc.shape[0],), float("-inf"), device=sc.device)
    return group_topk(sc, docs, th, kk)


def packed_flat(doc_words, tf_words, blk_tab, norm_ids, alive, blocks, qids,
                weights, caches, *, num_queries: int, kk: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] int32).

    CUDA tensors launch the kernel; CPU tensors take `packed_flat_ref`."""
    global launches
    dev = blocks.device
    check_tensor("doc_words", doc_words, torch.int32, 1, dev)
    check_tensor("tf_words", tf_words, torch.int32, 1, dev)
    check_tensor("blk_tab", blk_tab, torch.int32, 2, dev)
    check_tensor("norm_ids", norm_ids, torch.uint8, 1, dev)
    check_tensor("alive", alive, torch.bool, 1, dev)
    check_tensor("blocks", blocks, torch.int32, 1, dev)
    check_tensor("qids", qids, torch.int32, 1, dev)
    check_tensor("weights", weights, torch.float32, 1, dev)
    check_tensor("caches", caches, torch.float32, 2, dev)
    nb, max_doc, W = blk_tab.shape[0], norm_ids.shape[0], blocks.shape[0]
    if blk_tab.shape[1] != TAB_COLS:
        raise ValueError(f"blk_tab rows hold {blk_tab.shape[1]} columns, "
                         f"not {TAB_COLS}")
    if alive.shape[0] != max_doc:
        raise ValueError(f"alive has {alive.shape[0]} docs, norm_ids "
                         f"{max_doc}")
    if nb and not max_doc:
        raise ValueError("a mirror with blocks needs max_doc >= 1")
    if qids.shape[0] != W:
        raise ValueError(f"qids has {qids.shape[0]} items, blocks {W}")
    Qp = weights.shape[0]
    if tuple(caches.shape) != (Qp, CACHE_COLS):
        raise ValueError(f"caches shape {tuple(caches.shape)} != "
                         f"{(Qp, CACHE_COLS)}")
    if not 0 <= num_queries <= Qp:
        raise ValueError(f"num_queries={num_queries} outside the "
                         f"{Qp}-row tables")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    args = (doc_words, tf_words, blk_tab, norm_ids, alive, blocks, qids,
            weights, caches)
    if dev.type == "cpu":
        return packed_flat_ref(*args, num_queries=num_queries, kk=kk)
    if dev.type != "cuda":
        raise ValueError(f"packed_flat runs on cuda or cpu, not {dev}")
    lib = _lib()
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.packed_flat_launch(
            doc_words.data_ptr(), tf_words.data_ptr(), blk_tab.data_ptr(),
            nb, norm_ids.data_ptr(), alive.data_ptr(), max_doc,
            blocks.data_ptr(), qids.data_ptr(), W, weights.data_ptr(),
            caches.data_ptr(), num_queries, kk, out_sc.data_ptr(),
            out_doc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"packed_flat kernel launch failed: CUDA error {err}"
        )
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def packed_flat_topk(mirror, blocks, qids, weights, caches, k: int,
                     num_queries: int, rec: dict | None = None):
    """One launch chunk end to end: the kernel (its twin on the CPU) with
    row top-kk, kk = min(k, 128), then the per-query merge (kernel K8's
    rows form, `merge_tail.topk_from_rows`, which takes `rec`). `mirror`
    is a `device_index.PackedMirror`. Returns packed [2, Q, k] i32 (score
    bits | doc), -inf / 0 past a query's hits."""
    sc, docs = packed_flat(*mirror, blocks, qids, weights, caches,
                           num_queries=num_queries, kk=min(k, 128))
    return topk_from_rows(sc, docs, qids, k, num_queries, rec=rec)


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("packed_flat")
    if lib.packed_flat_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packed_flat_launch.argtypes = [
            p, p, p, i,            # doc_words, tf_words, blk_tab, n_blocks
            p, p, i,               # norm_ids, alive, max_doc
            p, p, i,               # blocks, qids, n_items
            p, p, i, i,            # weights, caches, num_queries, kk
            p, p, p,               # out_scores, out_docs, stream
        ]
        lib.packed_flat_launch.restype = ctypes.c_int
    return lib
