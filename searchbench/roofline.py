"""The least bytes each logged kernel launch must move, for the kernels'
roofline shares.

Frozen copies of `chip_smoke.py`'s byte counts (`merge_tail_bytes`,
`group_probe_bytes`, `phrase_probe_bytes` and their helpers): each takes
one launch as the executor's `launch_log` records it and counts once each
distinct input byte the launch needs, and each output byte. The fused
route's kernels are counted: K1 (`group_probe`), K2 (`phrase_probe`) and
K8 (`merge_tail`); a logged launch of another kind adds nothing, and the
readers then count only the kernels they have bytes for.
"""

from __future__ import annotations

import numpy as np


def launch_bytes(rec) -> dict[str, int]:
    """{kernel: bytes} of one launch record and its merge tail."""
    out: dict[str, int] = {}
    if "tail" in rec:
        out["merge_tail"] = merge_tail_bytes(rec["tail"]["args"])
    if rec["kind"] == "bool":
        out["group_probe"] = sum(group_probe_bytes(rec, rows)
                                 for rows, _, _ in rec["chunks"])
    elif rec["kind"] == "phrase":
        out["phrase_probe"] = sum(phrase_probe_bytes(rec, rr, rows)
                                  for rr, rows, _, _ in rec["chunks"])
    return out


def merge_tail_bytes(args) -> int:
    """The bytes one K8 call must move: its candidates (score and doc),
    a qid a row (and a segment a row in the seg form) read once, the
    packed result written once."""
    sc, _, seg, _, k, num_queries = args
    W, kk = sc.shape
    planes = 2 if seg is None else 3
    return W * kk * 8 + W * 4 * (planes - 1) + num_queries * k * 4 * planes


# -- the least bytes each kernel must move ------------------------------
#
# Each counter takes one chunk as the launch log recorded it and counts
# once each distinct input byte the chunk needs, and each output byte:
# the scalar rows, the plan-row tables, the member cstore rows, the probed
# cstore window rows (docs and tfs) or postore sub-ranges (position and
# owner), and the [W, kk] scores and docs. For K1-K3 and K5 the cstore and
# postore ranges are those the kernel reads, computed from the chunk's
# real rows as the kernel computes them. K4's and K6's probes need a few
# words of rows spread over wide regions, so their counters count 32-byte
# sectors of the work itself, whatever a build loads: the sector that
# settles each probe, the hits' tf sectors and the positions compared, and
# no search step; every build of K4 or K6 is read against that one bound.



def _covered(n: int, lo, hi) -> np.ndarray:
    """[n] bool: which indices the ranges [lo, hi) cover."""
    lo = np.maximum(np.asarray(lo, dtype=np.int64), 0)
    hi = np.minimum(np.asarray(hi, dtype=np.int64), n)
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    diff = (np.bincount(lo, minlength=n + 1)
            - np.bincount(hi, minlength=n + 1))
    return np.cumsum(diff[:n]) > 0


def _union_len(lo, hi) -> int:
    """How many integers the ranges [lo, hi) cover together."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    keep = hi > lo
    if not keep.any():
        return 0
    order = np.argsort(lo[keep], kind="stable")
    lo, hi = lo[keep][order], hi[keep][order]
    reach = np.maximum.accumulate(hi)
    # a range starts a new run of overlapping ranges when it begins past
    # every earlier range's end
    starts = np.nonzero(np.r_[True, lo[1:] > reach[:-1]])[0]
    return int((np.maximum.reduceat(hi, starts) - lo[starts]).sum())


def _np(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


def _small_bytes(rows, tables, kk: int) -> int:
    """Scalar rows, plan-row tables and the [W, kk] outputs."""
    return (rows.numel() * 4 + sum(t.numel() * 4 for t in tables)
            + rows.shape[0] * kk * 8)


def group_probe_bytes(rec, rows) -> int:
    """Kernel K1: member rows (docs, tfs, cachev: 1,536 bytes) and each
    clause's probed member sub-windows (docs and tfs: 1,024 bytes a row)."""
    r = _np(rows)
    T, nb = rec["n_clauses"], rec["cstore"].shape[0]
    prow, mask = r[:, 1], r[:, 3]
    live = (mask != 0) & (prow >= 0) & (prow < rec["num_prows"])
    m_lo, p_lo, p_hi = [], [], []
    for m in range(8):
        sel = live & (((mask >> m) & 1) == 1)
        m_lo.append(r[sel, 0] + m)
        for t in range(T):
            jlo = r[sel, 4 + t]
            packed = r[sel, 4 + T + 8 * t + m]
            ln = packed & 255
            ok = (ln > 0) & (jlo >= 0)
            p_lo.append((jlo + (packed >> 8))[ok])
            p_hi.append((jlo + (packed >> 8) + ln)[ok])
    m_lo = np.concatenate(m_lo)
    member = _covered(nb, m_lo, m_lo + 1)
    probed = _covered(nb, np.concatenate(p_lo), np.concatenate(p_hi))
    return (int(member.sum()) * 1536 + int((probed & ~member).sum()) * 1024
            + _small_bytes(rows, rec["tables"], min(rec["k"], 128)))


def phrase_probe_bytes(rec, rr: int, rows) -> int:
    """Kernel K2: member rows (docs and cachev: 1,024 bytes) and every
    position of the anchor and partner sub-ranges, cut to the slab window
    as the kernel cuts them (position and owner: 8 bytes each)."""
    r = _np(rows)
    S, nb = rec["n_partners"], rec["cstore"].shape[0]
    n_pos = rec["postore"].shape[0] * 128
    A = 4 + 2 * S
    prow, mask = r[:, 1], r[:, 2]
    live = (mask != 0) & (prow >= 0) & (prow < rec["num_prows"])

    def window(row0):
        lim = np.clip((rec["postore"].shape[0] - row0) * 128, 0, rr * 128)
        return row0 * 128, lim

    m_lo, lo, hi = [], [], []
    for m in range(8):
        sel = live & (((mask >> m) & 1) == 1)
        m_lo.append(r[sel, 0] + m)
        ranges = [(r[sel, 3], r[sel, A + m], r[sel, A + 8 + m])]
        ranges += [(r[sel, 4 + 2 * s], r[sel, A + 16 + 16 * s + m],
                    r[sel, A + 24 + 16 * s + m]) for s in range(S)]
        # partners are searched only for the member's anchor positions
        has_anchor = ranges[0][2] > 0
        for row0, off, ln in ranges:
            base, lim = window(row0)
            ok = (ln > 0) & has_anchor
            lo.append((base + np.maximum(off, 0))[ok])
            hi.append((base + np.minimum(off + ln, lim))[ok])
    m_lo = np.concatenate(m_lo)
    member = _covered(nb, m_lo, m_lo + 1)
    lo = np.concatenate(lo)
    n_pos_read = _union_len(lo, np.minimum(np.concatenate(hi), n_pos))
    return (int(member.sum()) * 1024 + n_pos_read * 8
            + _small_bytes(rows, (rec["qw"], rec["row_th"]),
                           min(rec["k"], 128)))

