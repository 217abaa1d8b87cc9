"""Windowed single-row boolean probe (kernel K3): window starts, the CUDA
kernel's wrapper, its plain PyTorch twin and the per-launch top-k tail.

Replaces the Pallas kernel `_bool_kernel_body` / `_probe_rows` and its
wrapper `pallas_bool_topk` in `tantivy_tpu/ops/pallas_probe.py`. The kernel
source and a note on its design are in `tantivy_tpu_torch/csrc/bool_probe.cu`.

Inputs, per launch chunk of W work items (one item = one cstore row of one
clause's posting block, for one query):
* `rows` [W, STRIDE] i32 — one scalar row per item (`bool_scal_stride`):
  0=bid, 1=qid (num_queries = padding), 2=lcl (the item's own clause),
  3+t=jlo_t (window start; -1 = no probe), 3+T+t=wid_t (rows to probe on
  the wide rung);
* per-query tables `cl_weight` [Qp, T] f32, `cl_kind`/`cl_start`/`cl_len`/
  `cl_shipped` [Qp, T] i32 (regions in cstore rows), `req_must`/`req_should`
  [Qp] i32;
* `cstore` [NB, 384] i32 (docs | tfs | bitcast(cachev), NaN = dead or pad).

Per lane, each clause t is probed in the window rows inside its region:
rows [jlo, jlo + max(kw, 2)) on the narrow rungs (kw <= 8); on the wide
rung rows [jlo, jlo + used8), used8 = min(s + n - jlo, wid) clamped to
[0, `_kw8(kw)`] and rounded up to 8, the rows the TPU kernel's 8-row chunk
loop reads. Scores and the reporting rule are those of
`probe_scorer.lane_scores`, which the deep probe shares. Output of the
kernel: per item its top-kk reporting lanes, scores [W, kk] f32 and docs
[W, kk] i32, ordered (score desc, lane asc) as `lax.top_k` orders the TPU
kernel's raw rows; -inf / TERMINATED fill.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..postings.format import TERMINATED

from .merge_tail import topk_from_rows
from .probe_scorer import (
    T_MAX,
    check_tensor,
    group_topk,
    lane_scores,
)

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: items the twin scores at once, bounding its [n, 128] temporaries
_TWIN_CHUNK = 8192


def _kw8(kw: int) -> int:
    """Window rows of rung kw: rounded up to 8, plus 8 slack rows on wide
    rungs only (the reference's DMA window)."""
    r = (kw + 7) & ~7
    return r + 8 if kw > 8 else max(r, 8)


def bool_scal_stride(n_clauses: int) -> int:
    """Scalar row stride for T clauses: 3 + 2T slots, padded to a power of
    two >= 8 (the reference's `_bool_scal_layout` stride)."""
    stride = 8
    while stride < 3 + 2 * n_clauses:
        stride *= 2
    return stride


def compute_jlo(dfp, work_blocks, work_qid, cl_start, cl_len, kw: int):
    """Window starts [N, T] in the (segment, field) store's own block ids:
    for each work item and clause, the first clause block whose last doc
    >= the item block's base doc, 8-aligned down and clamped so the rung's
    window stays inside the store (an empty region gives 0)."""
    n = len(work_blocks)
    T = cl_start.shape[1]
    kw8 = _kw8(kw)
    nbp = -(-dfp.num_blocks // 8) * 8
    out = np.zeros((n, T), dtype=np.int32)
    base = dfp.blk_base[work_blocks]
    order = np.argsort(work_qid, kind="stable")
    blast = dfp.blk_last_doc
    sorted_q = work_qid[order]
    bounds = np.searchsorted(sorted_q, np.arange(cl_start.shape[0] + 1))
    for q in np.unique(sorted_q):
        rows = order[bounds[q]:bounds[q + 1]]
        for t in range(T):
            s, ln = int(cl_start[q, t]), int(cl_len[q, t])
            if ln <= 0:
                continue
            j = s + np.searchsorted(blast[s:s + ln], base[rows])
            out[rows, t] = (np.minimum(j, max(nbp - kw8, 0)) // 8) * 8
    return out


def bool_probe_lanes(rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                     req_must, req_should, cstore, *, kw: int,
                     num_queries: int):
    """Plain PyTorch lane scores of the kernel, before its row selection:
    (scores [W, 128] f32, -inf = not reporting; docs [W, 128] i32, the
    item row's docs). The TPU kernel's raw output has this form; the
    scores are `probe_scorer.lane_scores`, bit for bit the kernel's."""
    W = rows.shape[0]
    T = cl_weight.shape[1]
    dev = rows.device
    nb = cstore.shape[0]
    Qp = cl_weight.shape[0]
    kw8 = _kw8(kw)
    out_sc = torch.empty((W, 128), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, 128), dtype=torch.int32, device=dev)
    for lo in range(0, W, _TWIN_CHUNK):
        r = rows[lo:lo + _TWIN_CHUNK].long()
        n = r.shape[0]
        bid, q, lcl = r[:, 0], r[:, 1], r[:, 2]
        live = (q >= 0) & (q < num_queries) & (bid >= 0) & (bid < nb)
        qc = q.clamp(0, Qp - 1)
        lane_rows = cstore[bid.clamp(0, nb - 1)]              # [n, 384]
        docs = lane_rows[:, :128]
        cachev = lane_rows[:, 256:].view(torch.float32)
        lane_ok = live[:, None] & (docs != TERMINATED) & ~torch.isnan(cachev)
        start, end = cl_start[qc].long(), (cl_start[qc] + cl_len[qc]).long()

        def probe(t):
            """Clause t's (found, tf) over the rows of its window that lie
            inside its region."""
            j = r[:, 3 + t]
            if kw <= 8:
                r1 = j + max(kw, 2)
            else:
                used = torch.minimum(end[:, t] - j, r[:, 3 + T + t])
                r1 = j + ((used.clamp(0, kw8) + 7) // 8) * 8
            r0 = torch.maximum(j, start[:, t])
            r1 = torch.minimum(torch.minimum(r1, end[:, t]),
                               torch.full_like(r1, nb))
            probed = live & (j >= 0) & (r1 > r0)
            found = torch.zeros((n, 128), dtype=torch.bool, device=dev)
            tf = torch.zeros((n, 128), dtype=torch.int32, device=dev)
            max_len = int((r1 - r0)[probed].max()) if bool(probed.any()) else 0
            for i in range(max_len):
                (gi,) = torch.nonzero(probed & (r0 + i < r1), as_tuple=True)
                if not len(gi):
                    continue
                win = cstore[r0[gi] + i]                      # [m, 384]
                win_docs = win[:, :128].contiguous()
                want = docs[gi]                               # [m, 128]
                pos = torch.searchsorted(win_docs, want).clamp(max=127)
                hit = win_docs.gather(1, pos) == want
                found[gi] |= hit
                tf[gi] += torch.where(hit, win[:, 128:256].gather(1, pos), 0)
            return found, tf

        out_sc[lo:lo + n] = lane_scores(
            probe, lcl, lane_rows[:, 128:256], cachev, lane_ok,
            cl_weight[qc], cl_kind[qc], cl_shipped[qc], req_must[qc],
            req_should[qc],
        )
        out_doc[lo:lo + n] = docs
    return out_sc, out_doc


def bool_probe_ref(rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                   req_must, req_should, cstore, *, kw: int,
                   num_queries: int, kk: int):
    """Plain PyTorch version of the kernel: `bool_probe_lanes`, then each
    row's top-kk reporting lanes by (score desc, lane asc)."""
    sc, docs = bool_probe_lanes(
        rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_must,
        req_should, cstore, kw=kw, num_queries=num_queries,
    )
    th = torch.full((sc.shape[0],), float("-inf"), device=sc.device)
    return group_topk(sc, docs, th, kk)


def bool_probe(rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
               req_must, req_should, cstore, *, kw: int, num_queries: int,
               kk: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] i32).

    CUDA tensors launch the kernel; CPU tensors take `bool_probe_ref`."""
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
    if cstore.shape[1] != 384:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} words, not 384")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{T} clauses outside 1..{T_MAX}")
    if not 3 + 2 * T <= rows.shape[1] <= 64:
        raise ValueError(f"scalar stride {rows.shape[1]} does not fit T={T}")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if kw < 1:
        raise ValueError(f"window rung kw={kw} < 1")
    if not 0 <= num_queries < Qp:
        raise ValueError(
            f"num_queries={num_queries} outside the {Qp}-row tables"
        )
    args = (rows, cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
            req_must, req_should, cstore)
    if dev.type == "cpu":
        return bool_probe_ref(*args, kw=kw, num_queries=num_queries, kk=kk)
    if dev.type != "cuda":
        raise ValueError(f"bool_probe runs on cuda or cpu, not {dev}")
    lib = _lib()
    W = rows.shape[0]
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bool_probe_launch(
            rows.data_ptr(), W, rows.shape[1], T, kw, cl_weight.data_ptr(),
            cl_kind.data_ptr(), cl_start.data_ptr(), cl_len.data_ptr(),
            cl_shipped.data_ptr(), req_must.data_ptr(),
            req_should.data_ptr(), num_queries, cstore.data_ptr(),
            cstore.shape[0], kk, out_sc.data_ptr(), out_doc.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bool_probe kernel launch failed: CUDA error {err}"
        )
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def bool_probe_topk(rows, tables, cstore, *, k: int, num_queries: int,
                    kw: int, rec: dict | None = None):
    """One windowed launch chunk end to end: the kernel (its twin on the
    CPU) with row top-kk, kk = min(k, 128), then the per-query merge
    (kernel K8's rows form, `merge_tail.topk_from_rows`, which takes
    `rec`). `tables` = (cl_weight, cl_kind, cl_start, cl_len,
    cl_shipped, req_must, req_should). Returns packed [2, Q, k] i32 (score
    bits | doc)."""
    sc, docs = bool_probe(rows, *tables, cstore, kw=kw,
                          num_queries=num_queries, kk=min(k, 128))
    return topk_from_rows(sc, docs, rows[:, 1].contiguous(), k, num_queries,
                          rec=rec)


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("bool_probe")
    if lib.bool_probe_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bool_probe_launch.argtypes = [
            p, i, i, i, i,         # rows, n_items, stride, n_clauses, kw
            p, p, p, p, p,         # cl_weight, cl_kind, cl_start, cl_len, ship
            p, p, i,               # req_must, req_should, num_queries
            p, ctypes.c_longlong, i,  # cstore, rows, kk
            p, p, p,               # out_scores, out_docs, stream
        ]
        lib.bool_probe_launch.restype = ctypes.c_int
    return lib
