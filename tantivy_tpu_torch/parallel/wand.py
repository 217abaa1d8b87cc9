"""Host-side Block-WAND planning utilities.

Block-max pruning decisions are tiny dense-array computations over per-block
skip metadata — classic host planning work. The score upper bound used for a
candidate block B of clause c is

    UB(B, c) = w_c * bfac[B] + sum_{c' != c, positive} w_c' * ovmax(c', range(B))

where `bfac[b] = tf_b / (tf_b + cache[fnid_b])` is the query-independent
block-max BM25 tf-factor (the stored `(fieldnorm_id, tf)` skip pair of
reference `skip.rs:175-184`) and `ovmax(c', [lo, hi])` is the max bfac over
c's blocks whose doc range intersects [lo, hi] — the same bound reference
`block_wand_union.rs:148-216` computes incrementally per pivot, evaluated
here for all blocks at once.
"""

from __future__ import annotations

import numpy as np


class RangeMax:
    """Sparse table for vectorized range-max queries over an f32 array.

    O(n log n) build, O(1) per query; `query` is fully vectorized.
    """

    def __init__(self, vals: np.ndarray):
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        self.n = len(vals)
        tables = [vals]
        j = 1
        while (1 << j) <= self.n:
            prev = tables[-1]
            half = 1 << (j - 1)
            m = self.n - (1 << j) + 1
            tables.append(np.maximum(prev[:m], prev[half : half + m]))
            j += 1
        self.tables = tables

    def query(self, i0: np.ndarray, i1: np.ndarray) -> np.ndarray:
        """max(vals[i0[r]:i1[r]]) per row; empty ranges yield 0.0."""
        i0 = np.asarray(i0, dtype=np.int64)
        i1 = np.minimum(np.asarray(i1, dtype=np.int64), self.n)
        length = i1 - i0
        out = np.zeros(len(i0), dtype=np.float32)
        nonempty = length > 0
        if not nonempty.any():
            return out
        lev = np.zeros(len(i0), dtype=np.int64)
        # floor(log2(n)) via frexp exponent (exact for ints < 2^53 and ~3x
        # cheaper than np.log2 on the planner's hot path)
        lev[nonempty] = np.frexp(length[nonempty])[1].astype(np.int64) - 1
        for j in np.unique(lev[nonempty]):
            sel = nonempty & (lev == j)
            t = self.tables[j]
            out[sel] = np.maximum(t[i0[sel]], t[i1[sel] - (1 << j)])
        return out


class FieldWand:
    """Per-(segment, field) cached block-max planning state."""

    def __init__(self, dfp, avg_fieldnorm: np.float32):
        from ..query.bm25 import compute_tf_cache

        self.dfp = dfp
        self.cache = compute_tf_cache(np.float32(avg_fieldnorm))
        tf = dfp.blk_max_tf.astype(np.float32)
        self.bfac = (tf / (tf + self.cache[dfp.blk_max_fnid])).astype(np.float32)
        self.rmax = RangeMax(self.bfac)

    def clause_blocks_ub(
        self,
        start: int,
        n: int,
        weight: np.float32,
        others: list,
        self_pos: int = 0,
        return_detail: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """For the clause region [start, start+n) of the block table, compute
        (block_ids, UB) with other-clause overlap bounds; blocks impossible
        under a MUST clause with no overlapping blocks are dropped.

        `others` = [(is_must, weight, start, n_blocks, pos)] for the query's
        other clauses present in this segment (weight 0.0 for MUST_NOT —
        they don't bound scores but their probe windows must still be
        sized); `pos`/`self_pos` are clause indices in the device kernel's
        summation order.

        **Exactness argument (replaces the former ±4e-6 ulp band):** the UB
        is accumulated per clause in the SAME index order and with the SAME
        f32 operations as the probe kernel's score loop
        (`probe_scorer.py`: `score += w_t * (tf/(tf+norm))`, t = 0..T-1;
        absent/non-positive clauses add literal 0.0, an exact identity on
        the non-negative partial sums). Each per-clause bound dominates the
        clause's true contribution (`bfac`/`ovmax` are maxima over the same
        f32 `tf/(tf+cache[fnid])` expression), and IEEE-754 rounding is
        monotone, so the running f32 UB dominates the running f32 score at
        every step: `ub >= score` holds *bit-exactly*, and a doc attaining
        every per-clause bound yields `ub == score` bit-for-bit. Hence
        `_phase2_keep` can prune on exact compares with no margin.

        Returns (block_ids, UB, widths): widths[i] is the widest other-clause
        block window overlapping block i — the probe kernel's per-work-item
        static window-size bucket is chosen from it (a block of a rare
        clause sees wide windows over a dense partner; a dense clause's
        blocks see ~1-3-block windows — bucketing per item keeps the common
        case cheap). Widths are measured from the 8-aligned-down window
        start (the kernel's DMA alignment), so `width <= kw` guarantees the
        kw-rung super-window covers the whole overlap.

        With `return_detail=True`, returns a dict additionally carrying the
        per-(block, other) aligned window starts (`jlo`), raw overlap bounds
        (`i0`/`i1`), and the per-clause-position f32 UB terms — what the
        fused planner needs to emit explicit kernel windows and to recompute
        per-slice UBs when a wide window is sliced.
        """
        dfp = self.dfp
        ids = np.arange(start, start + n, dtype=np.int64)
        lo = dfp.blk_base[ids].astype(np.uint64)
        hi = dfp.blk_last_doc[ids].astype(np.uint64)
        drop = np.zeros(n, dtype=bool)
        # per-(block, other-clause) overlap width — callers reduce with
        # .max(axis=1), or use per-clause widths for probe-skip decisions
        widths = np.zeros((n, len(others)), dtype=np.int64)
        jlo = np.zeros((n, len(others)), dtype=np.int64)
        i0s = np.zeros((n, len(others)), dtype=np.int64)
        i1s = np.zeros((n, len(others)), dtype=np.int64)
        terms: dict[int, np.ndarray] = {
            int(self_pos): (np.float32(weight) * self.bfac[ids]).astype(
                np.float32
            )
        }
        for oi, (is_must, w2, s2, n2, pos) in enumerate(others):
            blast = dfp.blk_last_doc[s2 : s2 + n2]
            bbase = dfp.blk_base[s2 : s2 + n2]
            i0 = s2 + np.searchsorted(blast, lo, side="left")
            i1 = s2 + np.searchsorted(bbase, hi, side="right")
            ov = self.rmax.query(i0, i1)
            if is_must:
                drop |= i1 <= i0
            terms[int(pos)] = (np.float32(w2) * ov).astype(np.float32)
            i0a = (i0 // 8) * 8
            jlo[:, oi] = i0a
            i0s[:, oi] = i0
            i1s[:, oi] = i1
            widths[:, oi] = i1 - i0a
        # accumulate in kernel clause order (see exactness argument above)
        ub = np.zeros(n, dtype=np.float32)
        for pos in sorted(terms):
            ub = (ub + terms[pos]).astype(np.float32)
        keep = ~drop
        if drop.any():
            ids, ub, widths = ids[keep], ub[keep], widths[keep]
        if return_detail:
            if drop.any():
                jlo, i0s, i1s = jlo[keep], i0s[keep], i1s[keep]
                terms = {p: t[keep] for p, t in terms.items()}
            return {
                "ids": ids, "ub": ub.astype(np.float32), "widths": widths,
                "jlo": jlo, "i0": i0s, "i1": i1s, "terms": terms,
            }
        return ids, ub.astype(np.float32), widths


def batched_clause_details(store, calls, cell_budget=8_000_000):
    """Vectorized `clause_blocks_ub(..., return_detail=True)` over MANY
    calls at once — the per-(query, clause, segment) planner loop was the
    round-4 boolean host-planning bottleneck (~2k small-numpy calls per
    256-query batch).

    `store` is the FusedStore; each call is `(start, n, weight, others,
    self_pos)` with `clause_blocks_ub` semantics. Results are bitwise
    identical to per-call evaluation: the same f32 expressions run
    elementwise (w2 * ov as f32, per-call UB accumulated in ascending
    clause-position order — absent positions add literal 0.0, an exact
    identity on the non-negative partial sums), and per-region searchsorted
    is replaced by ONE global searchsorted over the store's composite
    (region << 32 | doc) keys (`FusedStore.region_keys`).

    Calls are processed in chunks bounded by `cell_budget` matrix cells
    (rows x max-others), purely a memory cap — chunking cannot change any
    per-call result. Returns a list of detail dicts, aligned with `calls`.
    """
    out = []
    lo_c = 0
    while lo_c < len(calls):
        hi_c = lo_c
        cells = 0
        while hi_c < len(calls):
            st, n, w, others, sp = calls[hi_c]
            c = n * max(len(others), 1)
            if cells + c > cell_budget and hi_c > lo_c:
                break
            cells += c
            hi_c += 1
        out.extend(_batched_details_chunk(store, calls[lo_c:hi_c]))
        lo_c = hi_c
    return out


def _batched_details_chunk(store, calls):
    n_calls = len(calls)
    ns = np.array([c[1] for c in calls], dtype=np.int64)
    starts = np.array([c[0] for c in calls], dtype=np.int64)
    offs = np.zeros(n_calls + 1, dtype=np.int64)
    np.cumsum(ns, out=offs[1:])
    R = int(offs[-1])
    ids = np.repeat(starts - offs[:-1], ns) + np.arange(R, dtype=np.int64)
    lo = store.blk_base[ids].astype(np.uint64)
    hi = store.blk_last_doc[ids].astype(np.uint64)

    # pair table: one row per (call, other-clause)
    p_call, p_oi, p_s2, p_w2, p_pos, p_must = [], [], [], [], [], []
    o_max = 1
    for c_i, (st, n, w, others, sp) in enumerate(calls):
        o_max = max(o_max, len(others))
        for oi, (is_must, w2, s2, n2, pos) in enumerate(others):
            p_call.append(c_i)
            p_oi.append(oi)
            p_s2.append(s2)
            p_w2.append(np.float32(w2))
            p_pos.append(int(pos))
            p_must.append(bool(is_must))
    drop = np.zeros(R, dtype=bool)
    jlo_m = np.zeros((R, o_max), dtype=np.int32)
    i0_m = np.zeros((R, o_max), dtype=np.int32)
    i1_m = np.zeros((R, o_max), dtype=np.int32)
    wid_m = np.zeros((R, o_max), dtype=np.int32)
    pos_present: set[int] = set()
    terms_flat: dict[int, np.ndarray] = {}
    if p_call:
        p_call_a = np.array(p_call, dtype=np.int64)
        cnt = ns[p_call_a]
        pofs = np.zeros(len(p_call_a) + 1, dtype=np.int64)
        np.cumsum(cnt, out=pofs[1:])
        P = int(pofs[-1])
        rix = (
            np.repeat(offs[p_call_a] - pofs[:-1], cnt)
            + np.arange(P, dtype=np.int64)
        )
        sh = np.uint64(32)
        rid = np.repeat(np.array(p_s2, dtype=np.uint64), cnt) << sh
        cblast, cbbase = store.region_keys
        i0 = np.searchsorted(cblast, rid | lo[rix], side="left")
        i1 = np.searchsorted(cbbase, rid | hi[rix], side="right")
        ov = store.rmax.query(i0, i1)
        termv = (
            np.repeat(np.array(p_w2, dtype=np.float32), cnt) * ov
        ).astype(np.float32)
        must_rows = np.repeat(np.array(p_must, dtype=bool), cnt)
        bad = must_rows & (i1 <= i0)
        if bad.any():
            drop[rix[bad]] = True
        col = np.repeat(np.array(p_oi, dtype=np.int64), cnt)
        i0a = (i0 // 8) * 8
        jlo_m[rix, col] = i0a
        i0_m[rix, col] = i0
        i1_m[rix, col] = i1
        wid_m[rix, col] = i1 - i0a
        pos_rows = np.repeat(np.array(p_pos, dtype=np.int64), cnt)
        for pos in np.unique(pos_rows):
            arr = np.zeros(R, dtype=np.float32)
            sel = pos_rows == pos
            arr[rix[sel]] = termv[sel]
            terms_flat[int(pos)] = arr
            pos_present.add(int(pos))

    # self terms + per-call UB accumulation in ascending position order
    w_self = np.repeat(
        np.array([np.float32(c[2]) for c in calls], dtype=np.float32), ns
    )
    self_term = (w_self * store.bfac[ids]).astype(np.float32)
    self_pos_rows = np.repeat(
        np.array([c[4] for c in calls], dtype=np.int64), ns
    )
    for pos in np.unique(self_pos_rows):
        arr = terms_flat.get(int(pos))
        if arr is None:
            arr = terms_flat[int(pos)] = np.zeros(R, dtype=np.float32)
        sel = self_pos_rows == pos
        arr[sel] = self_term[sel]
        pos_present.add(int(pos))
    ub = np.zeros(R, dtype=np.float32)
    for pos in sorted(pos_present):
        ub = (ub + terms_flat[pos]).astype(np.float32)

    out = []
    for c_i, (st, n, w, others, sp) in enumerate(calls):
        s, e = int(offs[c_i]), int(offs[c_i + 1])
        keep = ~drop[s:e]
        all_keep = bool(keep.all())
        o_n = len(others)

        def cut(a):
            part = a[s:e]
            return part if all_keep else part[keep]

        positions = {int(p) for (_, _, _, _, p) in others} | {int(sp)}
        out.append({
            "ids": cut(ids),
            "ub": cut(ub),
            "widths": cut(wid_m)[:, :o_n],
            "jlo": cut(jlo_m)[:, :o_n],
            "i0": cut(i0_m)[:, :o_n],
            "i1": cut(i1_m)[:, :o_n],
            "terms": {p: cut(terms_flat[p]) for p in sorted(positions)},
        })
    return out
