"""Launch layer of the fused phrase path: anchor-block group collapse, slab
rung bucketing, chunk assembly, one position-probe kernel launch per chunk
and the merge tail.

Counterpart of `launch_fused_phrase` / `fused_phrase_topk` /
`_phrase_groups` in `tantivy_tpu/ops/pallas_phrase.py`, without jax. Each
chunk hands the kernel its per-group scalar rows as [W, STRIDE] int32, built
exactly as the reference builds them before folding them into SMEM pages.
The slab rungs and W tiers stay, so launches keep the reference's shapes and
slab windows; fully masked filler chunks, which the reference needs only
for Mosaic compile stability, are not launched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import debug_time

from .merge_tail import topk_rows_seg
from .phrase_probe import phrase_probe
from .probe_scorer import NEG_INF

#: slab rungs: (rows, W tiers in groups). `rows` bounds BOTH the anchor
#: slab and each partner slab a group reads; a rung admits a group when
#: every slab's aligned row need fits. Oversized groups split into
#: singleton groups, which always fit the widest rung (per-block caps below).
_PHRASE_RUNGS = (
    (24, (256, 8192, 32768)),
    (136, (256, 2048, 8192)),
)

#: per-BLOCK caps enforced by the planner: a single block's anchor slab /
#: partner span must fit the widest rung even after the 8-row alignment
#: slack, so the singleton-group split always fits.
ANCHOR_POS_CAP = (_PHRASE_RUNGS[-1][0] - 8) * 128
PARTNER_POS_CAP = (_PHRASE_RUNGS[-1][0] - 8) * 128


def max_slab_rows() -> int:
    return _PHRASE_RUNGS[-1][0]


def _phrase_scal_layout(n_partners: int) -> int:
    """Per-group scalar row stride (a power of two, as in the reference).
    Shared slots: 0=row_base (8-aligned cstore row), 1=prow, 2=member mask,
    3=arow0 (anchor slab row, host-clamped), then per partner s:
    4+2s=crow0_s, 5+2s=delta_s. Per member row r in 0..8: A+r=loff_r,
    A+8+r=llen_r, then per partner s: A+16+16s+r=off_rs, A+24+16s+r=len_rs,
    where A = 4 + 2*n_partners."""
    slots = 20 + 18 * n_partners
    stride = 8
    while stride < slots:
        stride *= 2
    return stride


def fused_phrase_topk(chunks, qw, row_th, cstore, postore, k: int,
                      num_queries: int, num_prows: int, n_partners: int,
                      rec: dict | None = None):
    """One batch phase: one position-probe launch per chunk, then the
    cross-chunk, cross-segment top-k merge tail (kernel K8's seg form,
    `merge_tail.topk_rows_seg`, which takes `rec`). `chunks`
    holds (slab rows RR, rows [W, STRIDE], qid [W], seg [W]). Returns
    packed [3, Q, k] (score bits | doc | seg)."""
    kk = min(k, 128)
    row_sc, row_doc, row_qid, row_seg = [], [], [], []
    for rr, rows, qid, seg in chunks:
        scores, docs = phrase_probe(
            rows, qw, row_th, cstore, postore, n_partners=n_partners,
            slab_rows=rr, num_prows=num_prows, kk=kk,
        )
        row_sc.append(scores)
        row_doc.append(docs)
        row_qid.append(qid)
        row_seg.append(seg)
    return topk_rows_seg(
        torch.cat(row_sc), torch.cat(row_doc), torch.cat(row_seg),
        torch.cat(row_qid), k, num_queries, rec=rec,
    )


def _phrase_groups(ids, prow, anchor, lpos, llen, cpos, clen):
    """Collapse per-block phrase work into masked 8-run groups keyed by
    (prow, anchor term, block//8). Returns per-group arrays: base, mask,
    prow_g, slab spans (amin/amax, cmin/cmax [n, S]), the row-major member
    scatter (lpos8/llen8 [n, 8], cpos8/clen8 [n, 8, S]) and the
    member->group index maps (io, order, starts, gidx)."""
    S = cpos.shape[1]
    key = (prow.astype(np.int64) * 64 + anchor) * (1 << 28) + ids // 8
    order = np.argsort(key, kind="stable")
    _, starts, counts = np.unique(
        key[order], return_index=True, return_counts=True
    )
    n_g = len(starts)
    io = order[starts]
    gidx = np.repeat(np.arange(n_g), counts)
    r = (ids[order] % 8).astype(np.int64)
    base = (ids[io] // 8) * 8
    mask = np.bitwise_or.reduceat(np.int64(1) << r, starts)
    lpos8 = np.zeros((n_g, 8), dtype=np.int64)
    llen8 = np.zeros((n_g, 8), dtype=np.int64)
    lpos8[gidx, r] = lpos[order]
    llen8[gidx, r] = llen[order]
    cpos8 = np.zeros((n_g, 8, S), dtype=np.int64)
    clen8 = np.zeros((n_g, 8, S), dtype=np.int64)
    cpos8[gidx, r] = cpos[order]
    clen8[gidx, r] = clen[order]
    amin = np.minimum.reduceat(lpos[order], starts)
    amax = np.maximum.reduceat(lpos[order] + llen[order], starts)
    i64max = np.iinfo(np.int64).max
    cmin = np.empty((n_g, S), dtype=np.int64)
    cmax = np.empty((n_g, S), dtype=np.int64)
    for s in range(S):
        cs, ce = cpos[order, s], cpos[order, s] + clen[order, s]
        has = clen[order, s] > 0
        cmin[:, s] = np.minimum.reduceat(np.where(has, cs, i64max), starts)
        cmax[:, s] = np.maximum.reduceat(np.where(has, ce, -1), starts)
    cmin = np.where(cmin == i64max, 0, cmin)
    cmax = np.maximum(cmax, cmin)
    return (base, mask, prow[io], amin, amax, cmin, cmax, lpos8, llen8,
            cpos8, clen8, io, order, gidx)


def _rows_needed(lo, hi):
    """Slab rows from the 8-aligned row holding `lo` to the row holding
    `hi - 1`."""
    r0 = (lo // 128) & ~7
    return -(-(hi - r0 * 128) // 128)


def launch_fused_phrase(fused, work, qw_table, n_partners: int, k: int,
                        num_queries: int, row_th=None,
                        log: list | None = None) -> list:
    """Group per-block phrase work items into masked 8-runs, assemble rung
    chunks and run one batch phase per round of chunks.

    `work` columns (numpy, per BLOCK): blocks [N], prow [N], qid [N],
    seg [N], lpos [N], llen [N], cpos [N, S], clen [N, S], delta [N, S],
    anchor [N] (anchor term index, group key only). `qw_table` [Pp] f32 is
    the phrase weight per plan row; `row_th` [Pp] f32 (optional) carries
    each plan row's current kth score for the threshold-bounded per-group
    selection. When `log` is a list, each round's exact kernel inputs are
    appended to it (its merge tail's under the record's "tail"). Returns a
    list of packed [3, Q, k] tensors on the store's device."""
    blocks, prow, qid, seg, lpos, llen, cpos, clen, delta, anchor = work
    if len(blocks) == 0:
        return []
    num_prows = len(qw_table) - 1
    S = n_partners
    # one pair of store tensors for the whole call (another batch may
    # replace the store's with grown copies meanwhile)
    cstore, postore = fused.cstore, fused.postore
    npr = postore.shape[0]
    device = cstore.device

    with debug_time("launch.phrase_groups", n=len(blocks)):
        (base, mask, prow_g, amin, amax, cmin, cmax, lpos8, llen8, cpos8,
         clen8, io, order, gidx) = _phrase_groups(
            blocks, prow, anchor, lpos, llen, cpos, clen
        )
    qid_g, seg_g = qid[io], seg[io]
    delta_g = delta[io]  # one query per group => one set of deltas

    need = _rows_needed(amin, amax)
    for s in range(S):
        need = np.maximum(need, _rows_needed(cmin[:, s], cmax[:, s]))

    # groups too fat for the widest rung split into singleton groups (each
    # block fits the widest rung by the planner's per-block caps)
    fat = need > max_slab_rows()
    if fat.any():
        sel = order[fat[gidx]]
        n_s = len(sel)
        r = (blocks[sel] % 8).astype(np.int64)
        one = np.arange(n_s)
        sl_lpos8 = np.zeros((n_s, 8), dtype=np.int64)
        sl_llen8 = np.zeros((n_s, 8), dtype=np.int64)
        sl_lpos8[one, r] = lpos[sel]
        sl_llen8[one, r] = llen[sel]
        sl_cpos8 = np.zeros((n_s, 8, S), dtype=np.int64)
        sl_clen8 = np.zeros((n_s, 8, S), dtype=np.int64)
        sl_cpos8[one, r] = cpos[sel]
        sl_clen8[one, r] = clen[sel]
        keep = ~fat

        def join(a, b):
            return np.concatenate([a[keep], b])

        base = join(base, (blocks[sel] // 8) * 8)
        mask = join(mask, np.int64(1) << (blocks[sel] % 8))
        prow_g = join(prow_g, prow[sel])
        qid_g = join(qid_g, qid[sel])
        seg_g = join(seg_g, seg[sel])
        delta_g = join(delta_g, delta[sel])
        lpos8 = join(lpos8, sl_lpos8)
        llen8 = join(llen8, sl_llen8)
        cpos8 = join(cpos8, sl_cpos8)
        clen8 = join(clen8, sl_clen8)
        amin = join(amin, lpos[sel])
        cmin = join(cmin, cpos[sel])
        need = join(need, np.maximum(
            _rows_needed(lpos[sel], lpos[sel] + llen[sel]),
            np.max(_rows_needed(cpos[sel], cpos[sel] + clen[sel]),
                   axis=1, initial=1),
        ))

    # one tier level shared by every rung, fixed for the whole phase (as in
    # the reference)
    per_rung = []
    prev = 0
    for rr, tiers in _PHRASE_RUNGS:
        sel = np.nonzero((need > prev) & (need <= rr))[0]
        prev = rr
        per_rung.append([rr, tiers, sel, 0])
    lvl = max(
        next((i for i, w in enumerate(tiers) if len(sel) <= w),
             len(tiers) - 1)
        for _, tiers, sel, _ in per_rung
    )
    STRIDE = _phrase_scal_layout(S)
    A = 4 + 2 * S

    def make_chunk(rr, tiers, sel_idx, lo):
        W = tiers[min(lvl, len(tiers) - 1)]
        hi = min(lo + W, len(sel_idx))
        n = hi - lo
        if n == 0:
            return None, hi
        idx = sel_idx[lo:hi]
        rows = np.zeros((W, STRIDE), dtype=np.int64)
        rows[:, 1] = num_prows
        arow0 = np.clip((amin[idx] // 128) & ~7, 0, npr - rr)
        rows[:n, 0] = base[idx]
        rows[:n, 1] = prow_g[idx]
        rows[:n, 2] = mask[idx]
        rows[:n, 3] = arow0
        loff = lpos8[idx] - arow0[:, None] * 128
        rows[:n, A:A + 8] = np.where(llen8[idx] > 0, loff, 0)
        rows[:n, A + 8:A + 16] = llen8[idx]
        for s in range(S):
            crow0 = np.clip((cmin[idx, s] // 128) & ~7, 0, npr - rr)
            rows[:n, 4 + 2 * s] = crow0
            rows[:n, 5 + 2 * s] = delta_g[idx, s]
            poff = cpos8[idx, :, s] - crow0[:, None] * 128
            rows[:n, A + 16 + 16 * s:A + 24 + 16 * s] = np.where(
                clen8[idx, :, s] > 0, poff, 0
            )
            rows[:n, A + 24 + 16 * s:A + 32 + 16 * s] = clen8[idx, :, s]
        q_pad = np.full(W, num_queries, dtype=np.int32)
        s_pad = np.zeros(W, dtype=np.int32)
        q_pad[:n] = qid_g[idx]
        s_pad[:n] = seg_g[idx]
        chunk = (rr,) + tuple(
            torch.from_numpy(a).to(device)
            for a in (rows.astype(np.int32), q_pad, s_pad)
        )
        return chunk, hi

    if row_th is None:
        row_th = np.full(num_prows + 1, NEG_INF, dtype=np.float32)
    qw_dev = torch.from_numpy(
        np.ascontiguousarray(qw_table, dtype=np.float32)
    ).to(device)
    th_dev = torch.from_numpy(
        np.ascontiguousarray(row_th, dtype=np.float32)
    ).to(device)

    outs = []
    while True:
        chunks = []
        with debug_time("launch.make_chunks"):
            for r in per_rung:
                chunk, r[3] = make_chunk(r[0], r[1], r[2], r[3])
                if chunk is not None:
                    chunks.append(chunk)
        if not chunks:
            break
        rec = None
        if log is not None:
            rec = dict(
                kind="phrase", chunks=chunks, qw=qw_dev, row_th=th_dev,
                cstore=cstore, postore=postore, k=k,
                num_queries=num_queries, num_prows=num_prows, n_partners=S,
            )
            log.append(rec)
        with debug_time("launch.dispatch"):
            outs.append(fused_phrase_topk(
                chunks, qw_dev, th_dev, cstore, postore, k,
                num_queries, num_prows, S, rec=rec,
            ))
        if all(r[3] >= len(r[2]) for r in per_rung):
            break
    return outs
