"""Deep per-lane boolean probe (kernel K4): the CUDA kernel's wrapper, its
plain PyTorch twin and the per-launch top-k tail.

Replaces the reference's XLA program `probe_bool_topk`
(`tantivy_tpu/ops/probe_scorer.py:398`), which scores the per-segment
Block-WAND path's work items whose clause windows are wider than the
windowed probe's widest rung (K3, `ops/bool_probe.py`). The kernel source
and a note on its design are in `tantivy_tpu_torch/csrc/deep_probe.cu`.

Inputs, per launch chunk of W work items (one item = one cstore row of one
clause's posting block, for one query):
* `rows` [W, 3] i32 — 0=bid, 1=qid (num_queries = padding), 2=lcl (the
  item's own clause);
* the per-query tables of `bool_probe` (`cl_weight` [Qp, T] f32,
  `cl_kind`/`cl_start`/`cl_len`/`cl_shipped` [Qp, T] i32 with regions in
  cstore rows, `req_must`/`req_should` [Qp] i32);
* `cstore` [NB, 384] i32 (docs | tfs | bitcast(cachev), NaN = dead or pad)
  and `blk_last` [NB] i32, each row's last doc.

Each lane's doc is looked up in every other clause's whole region; the
scores and reporting rule are `probe_scorer.lane_scores`'. Output: per item
its top-kk reporting lanes, scores [W, kk] f32 and docs [W, kk] i32,
ordered (score desc, lane asc); -inf / TERMINATED fill.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED
from .merge_tail import topk_from_rows
from .probe_scorer import (
    T_MAX,
    check_tensor,
    group_topk,
    lane_scores,
    probe_term,
)

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: columns of a launch row: bid, qid, lcl
ROW_COLS = 3


def deep_probe_ref(rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                   req_must, req_should, cstore, blk_last, *,
                   num_queries: int, kk: int, n_iters: int):
    """Plain PyTorch version of the kernel, the reference's XLA program
    written in torch: every lane binary-searches each clause region in
    `n_iters` fixed steps (`probe_term`; `n_iters` must cover the longest
    region, as `probe_scorer._iter_bucket` picks it), `lane_scores`, then
    each item's top-kk reporting lanes by (score desc, lane asc)."""
    r = rows.long()
    w = r.shape[0]
    nb = cstore.shape[0]
    Qp = cl_weight.shape[0]
    bid, q, lcl = r[:, 0], r[:, 1], r[:, 2]
    live = (q >= 0) & (q < num_queries) & (bid >= 0) & (bid < nb)
    qc = q.clamp(0, Qp - 1)
    lane_rows = cstore[bid.clamp(0, max(nb - 1, 0))]          # [W, 384]
    docs = lane_rows[:, :128]
    cachev = lane_rows[:, 256:].view(torch.float32)
    lane_ok = live[:, None] & (docs != TERMINATED) & ~torch.isnan(cachev)
    fdoc = docs.reshape(-1)
    start = cl_start[qc].long().repeat_interleave(128, dim=0)  # [W*128, T]
    n_blk = cl_len[qc].long().repeat_interleave(128, dim=0)

    def probe(t):
        found, tf = probe_term(cstore, blk_last, fdoc, start[:, t],
                               n_blk[:, t], n_iters)
        return found.view(w, 128), tf.view(w, 128)

    scores = lane_scores(
        probe, lcl, lane_rows[:, 128:256], cachev, lane_ok, cl_weight[qc],
        cl_kind[qc], cl_shipped[qc], req_must[qc], req_should[qc],
    )
    th = torch.full((w,), float("-inf"), device=cstore.device)
    return group_topk(scores, docs, th, kk)


def deep_probe(rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
               req_must, req_should, cstore, blk_last, *, num_queries: int,
               kk: int, n_iters: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] i32).

    CUDA tensors launch the kernel, whose searches are exact (so `n_iters`
    is the twin's only); CPU tensors take `deep_probe_ref`."""
    global launches
    dev = rows.device
    check_tensor("rows", rows, torch.int32, 2, dev)
    check_tensor("cl_weight", cl_weight, torch.float32, 2, dev)
    Qp, T = cl_weight.shape
    for name, x in (("cl_kind", cl_kind), ("cl_start", cl_start),
                    ("cl_len", cl_len), ("cl_shipped", cl_shipped)):
        check_tensor(name, x, torch.int32, 2, dev)
        if tuple(x.shape) != (Qp, T):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(Qp, T)}")
    for name, x in (("req_must", req_must), ("req_should", req_should)):
        check_tensor(name, x, torch.int32, 1, dev)
        if x.shape[0] != Qp:
            raise ValueError(f"{name} has {x.shape[0]} rows, want {Qp}")
    check_tensor("cstore", cstore, torch.int32, 2, dev)
    check_tensor("blk_last", blk_last, torch.int32, 1, dev)
    if cstore.shape[1] != 384:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} words, not 384")
    if blk_last.shape[0] != cstore.shape[0]:
        raise ValueError(f"blk_last has {blk_last.shape[0]} rows, cstore "
                         f"{cstore.shape[0]}")
    if rows.shape[1] != ROW_COLS:
        raise ValueError(f"launch rows hold {rows.shape[1]} columns, not "
                         f"{ROW_COLS}")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{T} clauses outside 1..{T_MAX}")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if not 0 <= num_queries < Qp:
        raise ValueError(
            f"num_queries={num_queries} outside the {Qp}-row tables"
        )
    args = (rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
            req_must, req_should, cstore, blk_last)
    if dev.type == "cpu":
        return deep_probe_ref(*args, num_queries=num_queries, kk=kk,
                              n_iters=n_iters)
    if dev.type != "cuda":
        raise ValueError(f"deep_probe runs on cuda or cpu, not {dev}")
    lib = _lib()
    W = rows.shape[0]
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.deep_probe_launch(
            rows.data_ptr(), W, T, cl_weight.data_ptr(), cl_kind.data_ptr(),
            cl_start.data_ptr(), cl_len.data_ptr(), cl_shipped.data_ptr(),
            req_must.data_ptr(), req_should.data_ptr(), num_queries,
            cstore.data_ptr(), blk_last.data_ptr(), cstore.shape[0], kk,
            out_sc.data_ptr(), out_doc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"deep_probe kernel launch failed: CUDA error {err}"
        )
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def deep_probe_topk(rows, tables, cstore, blk_last, *, k: int,
                    num_queries: int, n_iters: int,
                    rec: dict | None = None):
    """One deep launch chunk end to end: the kernel (its twin on the CPU)
    with item top-kk, kk = min(k, 128), then the per-query merge (kernel
    K8's rows form, `merge_tail.topk_from_rows`, which takes `rec`).
    `tables` = (cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
    req_must, req_should). Returns packed [2, Q, k] i32 (score bits |
    doc)."""
    sc, docs = deep_probe(rows, *tables, cstore, blk_last,
                          num_queries=num_queries, kk=min(k, 128),
                          n_iters=n_iters)
    return topk_from_rows(sc, docs, rows[:, 1].contiguous(), k, num_queries,
                          rec=rec)


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("deep_probe")
    if lib.deep_probe_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.deep_probe_launch.argtypes = [
            p, i, i,               # rows, n_items, n_clauses
            p, p, p, p, p,         # cl_weight, cl_kind, cl_start, cl_len, ship
            p, p, i,               # req_must, req_should, num_queries
            p, p, ctypes.c_longlong, i,  # cstore, blk_last, rows, kk
            p, p, p,               # out_scores, out_docs, stream
        ]
        lib.deep_probe_launch.restype = ctypes.c_int
    return lib
