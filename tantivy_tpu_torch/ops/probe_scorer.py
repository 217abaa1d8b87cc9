"""Planner constants and the cross-segment merge tail, in torch.

Counterpart of `tantivy_tpu/ops/probe_scorer.py` (which imports jax at the
top, so the constants are copied here). The merge tail was XLA in the
reference, not Pallas, so it is plain torch ops: torch has no multi-key
sort, so keys are packed into int64 and combined by chained stable sorts.
"""

from __future__ import annotations

import numpy as np
import torch

from tantivy_tpu.postings.format import TERMINATED

NEG_INF = np.float32(-np.inf)

#: max clauses per boolean query on the device path
T_MAX = 16

KIND_MUST = 0
KIND_SHOULD = 1
KIND_MUST_NOT = 2
KIND_ABSENT = 3

_T_LADDER = (2, 4, 8, T_MAX)

_U32 = 0xFFFFFFFF


def t_bucket(n: int) -> int:
    for t in _T_LADDER:
        if n <= t:
            return t
    raise ValueError(f"too many clauses for device path: {n}")


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


def per_query_topk_rows_seg(row_sc, row_doc, row_seg, qid, k: int,
                            num_queries: int):
    """[W, kk] per-group candidates -> per-query top-k (scores [Q, k] f32,
    docs [Q, k] i32, segs [Q, k] i32), ordered (qid asc, score desc, seg asc,
    doc asc). Duplicate addresses of one query are deduplicated keeping the
    max score before the top-k cut. This is the reference's 5-array form;
    its packed-address form gives the same result and saves a sort only in
    XLA's multi-key sort, so it is not ported."""
    w, kk = row_sc.shape
    dev = row_sc.device
    flat_scores = row_sc.reshape(-1)
    flat_docs = row_doc.reshape(-1).long()
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
    sq, sseg, sdoc, ssc = q1[p], sg1[p], d1[p], sc1[p]
    qs = torch.arange(num_queries + 1, device=dev)
    bounds = torch.searchsorted(sq, qs)
    firsts, nexts = bounds[:-1], bounds[1:]
    n = w * kk
    idx = firsts[:, None] + torch.arange(k, device=dev)[None, :]
    ok = idx < nexts[:, None]
    idx = idx.clamp(max=n - 1)
    out_sc = torch.where(ok, ssc[idx], float("-inf"))
    out_doc = torch.where(ok, sdoc[idx], 0).int()
    out_seg = torch.where(ok, sseg[idx], 0).int()
    return out_sc, out_doc, out_seg


def pack_results_seg(scores, docs, segs):
    """[3, Q, k] i32 (score bits | doc | seg): one device-to-host copy."""
    return torch.stack([scores.view(torch.int32), docs, segs])


def unpack_results_seg(packed_np):
    """Inverse of `pack_results_seg` on the host copy: (scores f32, docs
    u32, segs i32)."""
    return (packed_np[0].view(np.float32), packed_np[1].view(np.uint32),
            packed_np[2])
