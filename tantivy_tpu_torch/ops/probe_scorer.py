"""Planner constants, the merge tails' plain twins, the probe scorers'
shared lane combine and the per-segment probe dispatch, in torch.

Counterpart of `tantivy_tpu/ops/probe_scorer.py` (which imports jax at the
top, so the constants are copied here). The reference's two merge tails
(XLA programs) are kernel K8 on the card (`ops/merge_tail.py`,
`csrc/merge_tail.cu`); `per_query_topk_from_rows` and
`per_query_topk_rows_seg` here are its plain twins, which the wrapper runs
on CPU tensors: torch has no multi-key sort, so keys are packed into int64
and combined by chained stable sorts. `dispatch_probe` sends the
per-segment Block-WAND path's windowed work to kernel K3
(`ops/bool_probe.py`) and its wide work to kernel K4 (`ops/deep_probe.py`,
the reference's XLA `probe_bool_topk`), whose twins share `lane_scores`
and the deep twin's `probe_term`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..postings.format import TERMINATED
from ..utils.trace import debug_time

NEG_INF = np.float32(-np.inf)

#: max clauses per boolean query on the device path
T_MAX = 16

KIND_MUST = 0
KIND_SHOULD = 1
KIND_MUST_NOT = 2
KIND_ABSENT = 3

_T_LADDER = (2, 4, 8, T_MAX)

#: (work-list chunk size, probe window rows) rungs of the windowed kernel
_WKW_LADDER = ((65536, 2), (65536, 8), (8192, 64))
#: work-list ladder of the deep per-lane probe (windows wider than 64
#: rows); the port launches only real items, so only its top sizes chunks
_W_LADDER = (256, 4096)
#: block-index search depth buckets (covers <= 2^(n_iters-1) blocks/term)
_ITER_LADDER = (9, 15, 21)

_U32 = 0xFFFFFFFF


def t_bucket(n: int) -> int:
    for t in _T_LADDER:
        if n <= t:
            return t
    raise ValueError(f"too many clauses for device path: {n}")


def _iter_bucket(max_region_len: int) -> int:
    for it in _ITER_LADDER:
        if max_region_len <= (1 << (it - 1)):
            return it
    raise AssertionError(f"posting region too long: {max_region_len}")


def check_tensor(name, x, dtype, ndim, device):
    """Raise unless `x` is a contiguous `dtype` tensor of `ndim` dims on
    `device` (the kernels' wrappers check their inputs with it)."""
    if x.dtype != dtype or x.dim() != ndim or x.device != device:
        raise ValueError(
            f"{name}: want {dtype} with {ndim} dims on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def group_topk(sc, docs, th, kk: int):
    """Per-group top-kk of the kernels' twins: sc [n, 1024] f32 lane scores
    (-inf = not reporting) in flat (member row, lane) order, docs [n, 1024]
    i32, th [n] f32. Keeps the lanes with score >= th, ordered (score desc,
    flat index asc); -inf / TERMINATED fill. Returns ([n, kk], [n, kk])."""
    sur = (sc >= th[:, None]) & (sc != float("-inf"))
    n_sur = sur.sum(dim=1, keepdim=True)
    # survivors all score above every non-survivor, so the first n_sur of
    # the (score desc, flat asc) order are exactly the survivors
    top_sc, top_i = torch.sort(sc, dim=1, descending=True, stable=True)
    keep = torch.arange(kk, device=sc.device)[None, :] < n_sur
    return (
        torch.where(keep, top_sc[:, :kk], float("-inf")),
        torch.where(keep, docs.gather(1, top_i[:, :kk]), TERMINATED),
    )


def _sortable_desc(score):
    """f32 -> u32 key (held in int64) whose ascending order is score
    descending (`flat_scorer._sortable_desc`)."""
    bits = score.view(torch.int32).long() & _U32
    flipped = torch.where(bits >> 31 == 1, bits ^ _U32, bits | 0x80000000)
    return ~flipped & _U32


def _lexsort2(major, minor):
    """Permutation sorting by (major, minor), both int64."""
    p = torch.sort(minor, stable=True).indices
    return p[torch.sort(major[p], stable=True).indices]


def _take_k(sq, cols, k: int, num_queries: int):
    """First k entries of each query's run in the qid-sorted `sq`; (-inf,
    0, ...) past a run's end. `cols` = (scores, then int64 columns)."""
    dev = sq.device
    bounds = torch.searchsorted(sq, torch.arange(num_queries + 1, device=dev))
    firsts, nexts = bounds[:-1], bounds[1:]
    idx = firsts[:, None] + torch.arange(k, device=dev)[None, :]
    ok = idx < nexts[:, None]
    idx = idx.clamp(max=max(sq.shape[0] - 1, 0))
    out = [torch.where(ok, cols[0][idx], float("-inf"))]
    out += [torch.where(ok, c[idx], 0).int() for c in cols[1:]]
    return out


def pack_results(scores, docs):
    """[2, Q, k] i32 (score bits | doc): one device-to-host copy."""
    return torch.stack([scores.view(torch.int32), docs])


def unpack_results(packed_np):
    """Inverse of `pack_results` on the host copy: (scores f32, docs u32)."""
    return packed_np[0].view(np.float32), packed_np[1].view(np.uint32)


def per_query_topk_from_rows(row_sc, row_doc, qid, k: int, num_queries: int):
    """[W, kk] per-row candidates of one segment -> per-query top-k (scores
    [Q, k] f32, docs [Q, k] i32), ordered (qid asc, score desc, doc asc):
    TopNComputer's tie-break. As in the reference, there is no dedup: the
    primary-lane rule reports each doc of a query once per segment. Docs
    order as uint32, as the reference's do."""
    kk = row_sc.shape[1]
    flat_scores = row_sc.reshape(-1)
    flat_docs = row_doc.reshape(-1).long() & _U32
    flat_qid = torch.where(
        flat_scores == float("-inf"), num_queries,
        qid.long().repeat_interleave(kk),
    )
    p = _lexsort2((flat_qid << 32) | _sortable_desc(flat_scores), flat_docs)
    return _take_k(flat_qid[p], (flat_scores[p], flat_docs[p]), k,
                   num_queries)


def per_query_topk_rows_seg(row_sc, row_doc, row_seg, qid, k: int,
                            num_queries: int):
    """[W, kk] per-group candidates -> per-query top-k (scores [Q, k] f32,
    docs [Q, k] i32, segs [Q, k] i32), ordered (qid asc, score desc, seg asc,
    doc asc). Duplicate addresses of one query are deduplicated keeping the
    max score before the top-k cut. This is the reference's 5-array form;
    its packed-address form gives the same result and saves a sort only in
    XLA's multi-key sort, so it is not ported."""
    kk = row_sc.shape[1]
    flat_scores = row_sc.reshape(-1)
    flat_docs = row_doc.reshape(-1).long() & _U32
    flat_seg = row_seg.long().repeat_interleave(kk)
    flat_qid = torch.where(
        flat_scores == float("-inf"), num_queries,
        qid.long().repeat_interleave(kk),
    )
    skey = _sortable_desc(flat_scores)
    # dedup pass: group (qid, seg, doc), best score first in each run
    p = _lexsort2((flat_qid << 32) | flat_seg, (flat_docs << 32) | skey)
    q1, sg1, d1 = flat_qid[p], flat_seg[p], flat_docs[p]
    k1, sc1 = skey[p], flat_scores[p]
    dup = torch.zeros_like(q1, dtype=torch.bool)
    dup[1:] = (
        (q1[1:] == q1[:-1]) & (sg1[1:] == sg1[:-1]) & (d1[1:] == d1[:-1])
    )
    q1 = torch.where(dup, num_queries, q1)
    p = _lexsort2((q1 << 32) | k1, (sg1 << 32) | d1)
    return _take_k(q1[p], (sc1[p], d1[p], sg1[p]), k, num_queries)


def pack_results_seg(scores, docs, segs):
    """[3, Q, k] i32 (score bits | doc | seg): one device-to-host copy."""
    return torch.stack([scores.view(torch.int32), docs, segs])


def unpack_results_seg(packed_np):
    """Inverse of `pack_results_seg` on the host copy: (scores f32, docs
    u32, segs i32)."""
    return (packed_np[0].view(np.float32), packed_np[1].view(np.uint32),
            packed_np[2])


def binsearch_flat(flat, target, lo0, hi0, iters: int):
    """Vectorised lower-bound binary search of `target` [L] in the sorted
    slices flat[lo0[i]:hi0[i]], `iters` fixed steps (the reference's
    fori_loop). Returns the insertion index [L]."""
    nflat = flat.shape[0]
    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = lo + ((hi - lo) >> 1)
        go = flat[mid.clamp(max=nflat - 1)] < target
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo


def probe_term(cstore, blk_last, fdoc, blk_start, n_blk, blk_iters: int):
    """(presence, tf) of doc `fdoc` [L] in the term region [blk_start,
    blk_start + n_blk) of the cstore: a binary search over the per-block
    last docs finds the one candidate block, then a rank over its 128 docs
    finishes (the reference's `probe_term`)."""
    nb = blk_last.shape[0]
    blk = binsearch_flat(blk_last, fdoc, blk_start, blk_start + n_blk,
                         blk_iters)
    in_region = blk < blk_start + n_blk
    blk_safe = blk.clamp(max=nb - 1)
    drow = cstore[blk_safe, :128]                             # [L, 128]
    p_safe = (drow < fdoc[:, None]).sum(dim=1).clamp(max=127)
    found = in_region & (drow.gather(1, p_safe[:, None])[:, 0] == fdoc)
    return found, cstore[blk_safe, 128 + p_safe]


def lane_scores(probe, lcl, tfs, cachev, lane_ok, weight, kind, shipped,
                req_must, req_should):
    """Per-lane BM25 sum and reporting rule of the probe scorers (K3's twin
    and the deep probe): [n, 128] f32, -inf where a lane does not report.

    `probe(t)` gives clause t's (found [n, 128] bool, tf [n, 128] i32) for
    each lane's doc; the item's own clause `lcl` [n] is present with the
    lane's own tf `tfs`. `cachev` [n, 128] is the BM25 denominator,
    `lane_ok` [n, 128] marks live lanes of real items; weight/kind/shipped
    [n, T] and req_must/req_should [n] are the items' query tables. Each
    f32 operation is one correctly rounded torch op in clause order, as in
    the CUDA kernels. A lane reports when its clause is <= the primary
    (lowest present shipped) clause, the MUST and SHOULD counts are met and
    no MUST_NOT clause is present."""
    dev = cachev.device
    score = torch.zeros_like(cachev)
    cnt_must = torch.zeros(cachev.shape, dtype=torch.int32, device=dev)
    cnt_should = torch.zeros_like(cnt_must)
    has_not = torch.zeros(cachev.shape, dtype=torch.bool, device=dev)
    primary = torch.full_like(cnt_must, T_MAX + 1)
    for t in range(weight.shape[1]):
        found, tf_probe = probe(t)
        own = (lcl == t)[:, None]
        present = found | own
        tf = torch.where(own, tfs, tf_probe).float()
        kd = kind[:, t, None]
        contrib = weight[:, t, None] * (tf / (tf + cachev))
        positive = present & ((kd == KIND_MUST) | (kd == KIND_SHOULD))
        score = score + torch.where(positive, contrib, 0.0)
        cnt_must += (present & (kd == KIND_MUST)).int()
        cnt_should += (present & (kd == KIND_SHOULD)).int()
        has_not |= present & (kd == KIND_MUST_NOT)
        is_prim = present & (shipped[:, t, None] > 0) & (primary > T_MAX)
        primary = torch.where(is_prim, t, primary)
    ok = (
        lane_ok
        & (lcl[:, None] <= primary)
        & (cnt_must >= req_must[:, None])
        & (cnt_should >= req_should[:, None])
        & ~has_not
    )
    return torch.where(ok, score, float("-inf"))


def dispatch_probe(fused, slab, work_blocks, work_qid, work_clause, tables,
                   k: int, num_queries: int, work_width, log=None,
                   count=None) -> list:
    """Launch one (segment, field) group's work list: items bucketed by
    probe-window width (`work_width`, rows from the 8-aligned window start),
    then chunked by rung. Windowed rungs (kw 2, 8, 64) run kernel K3
    (`bool_probe.bool_probe_topk`); wider items run the deep per-lane
    kernel K4 (`deep_probe.deep_probe_topk`). The reference pads each chunk
    to its W rung with items of qid = num_queries, which never report; the
    port launches only the real items.

    Planning works in the slab's own block ids (the reference's per-field
    store); the slab's `offset` moves block ids, clause regions and window
    starts into the fused store's rows, so the kernels read the same rows
    the reference's per-field store holds. `tables` = cl_* [Q+1, T] and
    req_must/req_should [Q+1] numpy arrays. When `log` is a list, each
    chunk's exact inputs are appended to it (kind="probe" for K3, "deep"
    for K4; its merge tail's, kernel K8's, under the record's "tail");
    `count(kind)` is called once per launch ("probe_kw2", ...,
    "probe_deep"). Returns packed [2, Q, k] tensors on the store's
    device."""
    from .bool_probe import (
        _kw8,
        bool_probe_topk,
        bool_scal_stride,
        compute_jlo,
    )
    from .deep_probe import ROW_COLS, deep_probe_topk

    dfp, off = slab["dfp"], slab["offset"]
    # one store tensor for the whole call (another batch may replace
    # `fused.cstore` with a grown copy meanwhile)
    cstore = fused.cstore
    dev = cstore.device
    T = tables["cl_weight"].shape[1]
    n_iters = _iter_bucket(int(tables["cl_len"].max(initial=1)))
    with debug_time("probe.tables"):
        targs = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (
                tables["cl_weight"].astype(np.float32),
                tables["cl_kind"].astype(np.int32),
                (tables["cl_start"].astype(np.int64) + off).astype(np.int32),
                tables["cl_len"].astype(np.int32),
                tables["cl_shipped"].astype(np.int32),
                tables["req_must"].astype(np.int32),
                tables["req_should"].astype(np.int32),
            )
        )
    outs = []

    def launch(sel, wkw):
        blocks, qids, cls = work_blocks[sel], work_qid[sel], work_clause[sel]
        top = wkw[0] if wkw is not None else _W_LADDER[-1]
        for lo in range(0, len(blocks), top):
            b, q, c = blocks[lo:lo + top], qids[lo:lo + top], cls[lo:lo + top]
            rows = np.empty((len(b), ROW_COLS if wkw is None
                             else bool_scal_stride(T)), np.int32)
            rows[:, 0] = b + off
            rows[:, 1] = q
            rows[:, 2] = c
            if wkw is None:
                # a store rebuilt meanwhile only appends rows, so the first
                # rows of its table are this store's
                blk_last = fused.blk_last_device()[:cstore.shape[0]]
                with debug_time("probe.upload"):
                    rows_t = torch.from_numpy(rows).to(dev)
                rec = None
                if log is not None:
                    rec = dict(
                        kind="deep", rows=rows_t, tables=targs,
                        cstore=cstore, blk_last=blk_last, k=k,
                        num_queries=num_queries, n_iters=n_iters,
                        n_clauses=T,
                    )
                    log.append(rec)
                with debug_time("probe.launch_deep", n=len(b)):
                    outs.append(deep_probe_topk(
                        rows_t, targs, cstore, blk_last, k=k,
                        num_queries=num_queries, n_iters=n_iters, rec=rec,
                    ))
                kind = "probe_deep"
            else:
                kw = wkw[1]
                with debug_time("probe.jlo", n=len(b)):
                    rows[:, 3:3 + T] = compute_jlo(
                        dfp, b, q, tables["cl_start"], tables["cl_len"], kw
                    ) + off
                # the reference's legacy windowed path has no per-clause
                # widths: the wide rung probes its full window
                rows[:, 3 + T:] = _kw8(kw)
                with debug_time("probe.upload"):
                    rows_t = torch.from_numpy(rows).to(dev)
                rec = None
                if log is not None:
                    rec = dict(
                        kind="probe", rows=rows_t, tables=targs,
                        cstore=cstore, kw=kw, k=k,
                        num_queries=num_queries, n_clauses=T,
                    )
                    log.append(rec)
                with debug_time("probe.launch_windowed", n=len(b)):
                    outs.append(bool_probe_topk(
                        rows_t, targs, cstore, k=k,
                        num_queries=num_queries, kw=kw, rec=rec,
                    ))
                kind = f"probe_kw{kw}"
            if count is not None:
                count(kind)

    prev_kw = -1  # width 0 (no partner clauses) lands in the first rung
    for wkw in _WKW_LADDER:
        sel = (work_width > prev_kw) & (work_width <= wkw[1])
        if sel.any():
            launch(sel, wkw)
        prev_kw = wkw[1]
    sel = work_width > _WKW_LADDER[-1][1]
    if sel.any():
        launch(sel, None)
    return outs
