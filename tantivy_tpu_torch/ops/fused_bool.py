"""Launch layer of the fused boolean path: group collapse, rung bucketing,
chunk assembly, one group-probe kernel launch per rung and the merge tail.

Counterpart of `launch_fused_bool` / `fused_bool_topk` / `_group_work` in
`tantivy_tpu/ops/pallas_probe.py`, without jax. Each chunk hands the kernel
its per-group scalar rows as [W, STRIDE] int32, built exactly as the
reference builds them before folding them into SMEM pages. The rung and
tier ladders stay for now, so launches keep the reference's shapes; fully
masked filler chunks, which the reference needs only for Mosaic compile
stability, are not launched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import debug_time

from .group_probe import group_probe
from .merge_tail import topk_rows_seg
from .probe_scorer import NEG_INF, T_MAX


def _grp_scal_layout(n_clauses: int) -> int:
    """Per-group scalar row stride (a power of two, as in the reference):
    0=row_base (8-aligned), 1=prow, 2=lcl, 3=member mask, 4+t=jlo_t (-1 =
    no probe), then at A + 8t + r member r's packed clause-t sub-window
    (off << 8) | len, A = 4 + n_clauses."""
    slots = 4 + n_clauses + 8 * n_clauses
    stride = 8
    while stride < slots:
        stride *= 2
    return stride


def _grp_kw8(kw: int) -> int:
    """Window rows a rung covers: kw rounded up to 8 (the planner's
    member sub-windows must end inside it)."""
    return max((kw + 7) & ~7, 8)


#: window rungs and their W tiers (in groups), as in the reference
_GRP_RUNGS = (16, 64)            # T <= 8
_GRP_RUNGS_WIDE = (16, 32)       # T <= 16
_GRP_W_TIERS = {
    16: (256, 8192, 65536),
    32: (256, 2048, 8192),
    64: (256, 2048, 8192),
}


def fused_rungs(n_clauses: int) -> tuple:
    return _GRP_RUNGS if n_clauses <= 8 else _GRP_RUNGS_WIDE


def fused_kw_max(n_clauses: int) -> int:
    """Widest fused probe window for a clause bucket; wider work items are
    re-enumerated through a denser clause by the planner ("window
    explosion"), not sent to the host."""
    return fused_rungs(n_clauses)[-1]


def fused_bool_topk(chunks, tables, cstore, k: int, num_queries: int,
                    num_prows: int, rec: dict | None = None):
    """One batch phase: one group-probe launch per chunk, then the
    cross-chunk, cross-segment top-k merge tail (kernel K8's seg form,
    `merge_tail.topk_rows_seg`, which takes `rec`). `chunks`
    holds (rows [W, STRIDE], qid [W], seg [W]) tensors; `tables` holds
    (cl_weight, cl_kind, cl_shipped, req_must, req_should, row_th).
    Returns packed [3, Q, k] (score bits | doc | seg)."""
    kk = min(k, 128)
    row_sc, row_doc, row_qid, row_seg = [], [], [], []
    for rows, qid, seg in chunks:
        scores, docs = group_probe(
            rows, *tables, cstore, num_prows=num_prows, kk=kk
        )
        row_sc.append(scores)
        row_doc.append(docs)
        row_qid.append(qid)
        row_seg.append(seg)
    return topk_rows_seg(
        torch.cat(row_sc), torch.cat(row_doc), torch.cat(row_seg),
        torch.cat(row_qid), k, num_queries, rec=rec,
    )


_I32MAX = np.iinfo(np.int32).max

#: sentinel: the grouping key was already sorted, no order-gather needed
_SORTED = object()


def _group_work(blocks, prow, clause, qid, seg, jlo_all, wid_all, frc_all,
                groupable, kw_max: int):
    """Collapse per-block work items into masked 8-run GROUP items (see
    `_group_work_np`), through the native single-pass collapse when it
    applies.

    The native pass keeps at most 8 members per run, so a run can exceed
    it only through duplicate (prow, clause, block) items; when the run is
    also wider than `kw_max` it would emit fewer singletons than numpy.
    The planner emits no such duplicates, but inputs that hold them (or
    are unsorted) take the numpy path, so both paths give one launch."""
    from ..native_probe import group_work_sorted

    if _strictly_sorted_members(blocks, prow, clause, groupable):
        native = group_work_sorted(
            blocks, prow, clause, qid, seg, jlo_all, wid_all, frc_all,
            groupable, kw_max,
        )
        if native is not None:
            return native
    return _group_work_np(blocks, prow, clause, qid, seg, jlo_all, wid_all,
                          frc_all, groupable, kw_max)


def _strictly_sorted_members(blocks, prow, clause, groupable) -> bool:
    g = np.asarray(groupable, dtype=bool)
    key = (
        prow[g].astype(np.int64) * (T_MAX + 1) + clause[g]
    ) * (1 << 28) + blocks[g]
    return len(key) < 2 or bool((np.diff(key) > 0).all())


def _group_work_np(blocks, prow, clause, qid, seg, jlo_all, wid_all,
                   frc_all, groupable, kw_max: int):
    """Numpy group collapse.

    Groupable items sharing (prow, clause, block//8) merge: member mask ORs,
    per-clause windows union, and each member's own TRUE sub-range within
    the union — (jlo + frc) - jlo_group rows in, (wid - frc) rows long,
    where `frc` is the planner's alignment fraction (true first overlapping
    row minus the 8-aligned window start) — rides per-member scalars packed
    (off << 8) | len, so the kernel probes exactly the member's overlap.
    Non-groupable items (slice plans with intentionally partial windows)
    and groups whose unioned width exceeds `kw_max` are emitted as
    singleton groups. Returns (base, mask, prow, clause, qid, seg, jlo
    [N,T], pk [N,T,8] packed member windows, eff)."""
    T = jlo_all.shape[1]

    def emit(b_g, mask, p, c, q, s, jlo_m8, wid_m8, frc_m8):
        """jlo_m8/wid_m8/frc_m8: [n, 8, T] per-member windows (-1 = none).
        int32 throughout: store rows < 2^31, widths <= kw_max, frc < 8."""
        n = len(b_g)
        has = jlo_m8 >= 0
        jmin = np.where(has, jlo_m8, _I32MAX).min(axis=1)      # [n, T]
        jlo_g = np.where(jmin == _I32MAX, np.int32(-1), jmin)
        i1 = np.where(has, jlo_m8 + wid_m8, np.int32(-1)).max(axis=1)
        wid_g = np.where(jlo_g >= 0, i1 - jlo_g, 0)
        off8 = np.where(
            has, jlo_m8 - jlo_g[:, None, :] + frc_m8, 0
        )                                                       # [n, 8, T]
        len8 = np.maximum(np.where(has, wid_m8 - frc_m8, 0), 0)
        pk = np.where(len8 > 0, (off8 << 8) | len8, 0)
        eff = wid_g.max(axis=1) if T else np.zeros(n, dtype=np.int32)
        return (b_g, mask, p, c, q, s, jlo_g, pk.transpose(0, 2, 1), eff)

    def member_windows(sel, order=None, starts=None, gidx=None, r=None):
        """Scatter per-item windows into [n, 8, T] member slots."""
        jlo = jlo_all[sel].astype(np.int32)
        wid = np.where(jlo >= 0, wid_all[sel].astype(np.int32), 0)
        frc = np.where(jlo >= 0, frc_all[sel].astype(np.int32), 0)
        if order is None:  # singletons
            n = len(jlo)
            j8 = np.full((n, 8, T), -1, dtype=np.int32)
            w8 = np.zeros((n, 8, T), dtype=np.int32)
            f8 = np.zeros((n, 8, T), dtype=np.int32)
            rr = (blocks[sel] % 8).astype(np.int64)
            j8[np.arange(n), rr] = jlo
            w8[np.arange(n), rr] = wid
            f8[np.arange(n), rr] = frc
            return j8, w8, f8
        n = len(starts)
        j8 = np.full((n, 8, T), -1, dtype=np.int32)
        w8 = np.zeros((n, 8, T), dtype=np.int32)
        f8 = np.zeros((n, 8, T), dtype=np.int32)
        if order is _SORTED:
            j8[gidx, r] = jlo
            w8[gidx, r] = wid
            f8[gidx, r] = frc
        else:
            j8[gidx, r] = jlo[order]
            w8[gidx, r] = wid[order]
            f8[gidx, r] = frc[order]
        return j8, w8, f8

    def singles(sel):
        b = blocks[sel]
        j8, w8, f8 = member_windows(sel)
        return emit(
            (b // 8) * 8, np.int64(1) << (b % 8), prow[sel], clause[sel],
            qid[sel], seg[sel], j8, w8, f8,
        )

    parts = []
    ng = ~groupable
    if ng.any():
        parts.append(singles(ng))
    gsel = groupable
    if gsel.any():
        b = blocks[gsel]
        run = b // 8
        key = (
            prow[gsel].astype(np.int64) * (T_MAX + 1) + clause[gsel]
        ) * (1 << 28) + run
        # the planner emits items in (prow, clause, block) order, so the
        # grouping key is almost always pre-sorted — skip the O(n log n)
        # argsort and the order-gather in that case
        if len(key) < 2 or bool((np.diff(key) >= 0).all()):
            order = _SORTED
            sorted_key, bo = key, b
        else:
            order = np.argsort(key, kind="stable")
            sorted_key, bo = key[order], b[order]
        _, starts, counts = np.unique(
            sorted_key, return_index=True, return_counts=True
        )
        n_g = len(starts)
        gidx = np.repeat(np.arange(n_g), counts)
        r = (bo % 8).astype(np.int64)
        mask = np.bitwise_or.reduceat(np.int64(1) << r, starts)
        base = (bo[starts] // 8) * 8
        io = starts if order is _SORTED else order[starts]
        j8, w8, f8 = member_windows(gsel, order, starts, gidx, r)
        g = emit(base, mask, prow[gsel][io], clause[gsel][io], qid[gsel][io],
                 seg[gsel][io], j8, w8, f8)
        # unioned window busts the widest rung -> demote to singletons
        wide = g[-1] > kw_max
        if wide.any():
            wide_keys = sorted_key[starts[wide]]
            item_wide = np.isin(key, wide_keys)
            idx_w = np.nonzero(gsel)[0][item_wide]
            selw = np.zeros(len(blocks), dtype=bool)
            selw[idx_w] = True
            parts.append(singles(selw))
            keep = ~wide
            parts.append(tuple(v[keep] for v in g))
        else:
            parts.append(g)
    return tuple(
        np.concatenate([p[i] for p in parts]) for i in range(9)
    )


def launch_fused_bool(fused, work, tables, k: int, num_queries: int,
                      log: list | None = None) -> list:
    """Assemble per-rung group scalar rows from the planner's work list and
    run one batch phase per round of chunks.

    `work` = (blocks [N], prow [N], clause [N], width [N], qid [N], seg [N],
    jlo [N, T], wid [N, T], frc [N, T], groupable [N]) numpy arrays: each
    item's per-clause window start (8-aligned; -1 = skip that clause's
    probe), overlap width measured from that start, and the alignment
    fraction `frc` (the kernel probes the TRUE range [jlo+frc, jlo+wid)).
    `tables` = dict of plan-row tables (cl_* [P+1, T], req_*, optional
    row_th). `k` may be inflated by the planner (k_eff). When `log` is a
    list, each round's exact kernel inputs are appended to it (its merge
    tail's under the record's "tail"). Returns a list of packed [3, Q, k]
    tensors on the store's device."""
    (blocks, prow, clause, width, qid, seg, jlo_all, wid_all, frc_all,
     groupable) = work
    n_items = len(blocks)
    if n_items == 0:
        return []
    T = tables["cl_weight"].shape[1]
    num_prows = tables["cl_weight"].shape[0] - 1
    # one store tensor for the whole call (another batch may replace
    # `fused.cstore` with a grown copy meanwhile)
    cstore = fused.cstore
    nbp = -(-cstore.shape[0] // 8) * 8
    rungs_t = fused_rungs(T)
    device = cstore.device

    with debug_time("launch.group_work", n=n_items):
        base, mask, g_prow, g_cl, g_qid, g_seg, g_jlo, g_pk, eff = \
            _group_work(
                blocks, prow, clause, qid, seg, jlo_all, wid_all, frc_all,
                groupable, rungs_t[-1],
            )

    # bucket per rung, clamping window starts so each rung's window stays
    # inside the store (8-aligned; -1 skip sentinels pass through). A clamp
    # shifts member offsets deeper into the window; shifted ends stay
    # <= kw8 because region ends never exceed the padded store.
    per_rung = []
    prev_kw = -1
    with debug_time("launch.bucket", n=len(base)):
        for kw in rungs_t:
            sel = (eff > prev_kw) & (eff <= kw)
            prev_kw = kw
            kw8 = _grp_kw8(kw)
            hi = (max(nbp - kw8, 0) // 8) * 8
            j_orig = g_jlo[sel].astype(np.int32)
            j_s = np.where(j_orig < 0, np.int32(-1), np.minimum(j_orig, hi))
            shift = np.where(j_orig < 0, np.int32(0), j_orig - j_s)
            pk = g_pk[sel].astype(np.int32)
            pk_s = np.where(pk > 0, pk + (shift[:, :, None] << 8), 0)
            if pk_s.size and int(((pk_s >> 8) + (pk_s & 255)).max()) > kw8:
                raise AssertionError(
                    "member window beyond the rung's window rows"
                )
            per_rung.append(
                [kw, base[sel], mask[sel], g_prow[sel], g_cl[sel],
                 g_qid[sel], g_seg[sel], j_s, pk_s, 0]
            )
    if sum(len(r[1]) for r in per_rung) != len(base):
        raise AssertionError(
            "group item wider than the widest rung reached the launcher"
        )

    # one tier level shared by every rung, recomputed from the remaining
    # work before each round (as in the reference)
    def _shared_level():
        lvl = 0
        for r in per_rung:
            kw, n_left = r[0], len(r[1]) - r[9]
            tiers = _GRP_W_TIERS[kw]
            lvl = max(
                lvl,
                next((i for i, w in enumerate(tiers) if n_left <= w),
                     len(tiers) - 1),
            )
        return lvl

    def make_chunk(kw, b_s, m_s, p_s, c_s, q_s, s_s, jlo, pk, lo, level):
        tiers = _GRP_W_TIERS[kw]
        W = tiers[min(level, len(tiers) - 1)]
        hi = min(lo + W, len(b_s))
        n = hi - lo
        if n == 0:
            return None, hi
        STRIDE = _grp_scal_layout(T)
        A = 4 + T
        rows = np.zeros((W, STRIDE), dtype=np.int32)
        rows[:, 1] = num_prows
        rows[:, 4:4 + T] = -1
        q_pad = np.full(W, num_queries, dtype=np.int32)
        s_pad = np.zeros(W, dtype=np.int32)
        rows[:n, 0] = b_s[lo:hi]
        rows[:n, 1] = p_s[lo:hi]
        rows[:n, 2] = c_s[lo:hi]
        rows[:n, 3] = m_s[lo:hi]
        rows[:n, 4:4 + T] = jlo[lo:hi]
        rows[:n, A:A + 8 * T] = pk[lo:hi].reshape(n, 8 * T)
        q_pad[:n] = q_s[lo:hi]
        s_pad[:n] = s_s[lo:hi]
        chunk = tuple(
            torch.from_numpy(a).to(device) for a in (rows, q_pad, s_pad)
        )
        return chunk, hi

    row_th = tables.get("row_th")
    if row_th is None:
        row_th = np.full(num_prows + 1, NEG_INF, dtype=np.float32)
    table_args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (
            tables["cl_weight"].astype(np.float32),
            tables["cl_kind"].astype(np.int32),
            tables["cl_shipped"].astype(np.int32),
            tables["req_must"].astype(np.int32),
            tables["req_should"].astype(np.int32),
            row_th.astype(np.float32),
        )
    )

    outs = []
    while True:
        lvl_shared = _shared_level()
        chunks = []
        with debug_time("launch.make_chunks"):
            for r in per_rung:
                chunk, hi = make_chunk(*r[:9], r[9], lvl_shared)
                r[9] = hi
                if chunk is not None:
                    chunks.append(chunk)
        if not chunks:
            break
        rec = None
        if log is not None:
            rec = dict(
                kind="bool", chunks=chunks, tables=table_args,
                cstore=cstore, k=k,
                num_queries=num_queries, num_prows=num_prows, n_clauses=T,
            )
            log.append(rec)
        with debug_time("launch.dispatch"):
            outs.append(fused_bool_topk(
                chunks, table_args, cstore, k, num_queries, num_prows,
                rec=rec,
            ))
        if all(r[9] >= len(r[1]) for r in per_rung):
            break
    return outs
