"""Synthetic launch chunks for the boolean probe kernels K1 (group probe),
K3 (windowed probe) and K4 (deep probe), the packed flat scorer K5, the
per-segment phrase probe K6, the dense flat scorer K7 and the merge tails
K8, made from a seed with numpy: the shapes the real launches seldom reach
and the kernels' designs find hard. The tests hold the plain twins against
the reference kernels on them, and the card checks
(`tests/test_torch_*_probe.py`, `chip_smoke.py`) hold the CUDA kernels
against the twins.

Every store is built like the fused store's (`build_cstore_np`): term
regions of sorted docs, each starting on an 8-row boundary, tfs of 1 or 2
and two BM25 denominators, so equal scores straddle every top-kk cut; some
docs are deleted (NaN denominators). Inside a region docs ascend strictly
across rows, with TERMINATED padding after the last doc, as the kernels'
fence searches require. Chunks are padded to 64 items (fully masked groups,
or items of qid = num_queries), a multiple of every reference grid step.

K1 kinds (`group_case`):
* "ties": phase 1 (no threshold), every group has all 8 members live and
  every lane reporting: 1,024 survivors whose scores tie across the cut;
* "t16": 16 clauses, all 8 members live, every clause (the own one too)
  probed by every member, a finite row threshold;
* "wide": member sub-windows whose union spans more than 16 rows, so
  probes take several fence steps (rung kw = 64);
* "oversized": 255-row sub-windows whose union spans more than 256 rows,
  the kernel's longest fence searches; no reference rung reaches it, so
  only the twin defines it.
K3 kinds (`bool_case`):
* "every_row": the wide rung (kw = 64) with lane docs in every row of a
  70-row window, the region's last row included (TERMINATED padding);
* "store_end": windows that end at the store's last row (kw = 8 or 64).
K4 kinds (`deep_case`), each lane doc looked up in whole clause regions:
* "ladder_edge": a partner region of 256 rows, 2^(n_iters - 1) for the
  search depth n_iters = 9 that the reference picks for it, the widest
  region that depth covers; lane docs are the region's first and last
  docs, a doc of every fourth row, docs below and above every region and
  docs between rows;
* "t16": 16 clauses, partner regions of 1 to 300 rows (search depth 15),
  two of them empty (terms the segment lacks), MUST, SHOULD and MUST_NOT;
* "stage_edges": two clauses, each item's live docs spread over partner
  ranges of 1 row (every live lane in one row), 2,047, 2,048 and 2,049
  rows (below, at and above the kernel's staged `blk_last` cap) and 3
  rows with one live lane; docs of the partner and docs between them.
K5 kinds (`packed_case`), packed mirrors built from random deltas:
* "widths": a block of every doc width (0 to 32) at full and short
  lengths, tf rows of every width, words with the top bit set (width-32
  deltas wrap the doc ids past 2^32, width-32 tfs wrap to 0), a block whose
  last doc is max_doc - 1, a block whose docs are all deleted, blocks
  repeated for one query and padding items;
* "no_freqs": a field without freqs (every tf 1, no tf words), two
  field-norm ids, so equal scores straddle every top-kk cut;
* "ties": no freqs and one field-norm id, so every live lane of an item
  ties with the others and lane order alone decides each cut; two queries
  weigh 0.0 and -0.0 (all-zero scores of either sign).
K7 kinds (`dense_case`), one chunk in both of K7's forms (fused-store rows
and dense docs/tfs rows with per-query denominator tables), every item's
row repeated or not, padding items (qid = num_queries) holding real rows:
* "ties": every tf 1 and one field-norm id, so every live lane of an item
  ties with the others and lane order alone decides each cut; two queries
  weigh 0.0 and -0.0;
* "dead": a row whose docs are all deleted, a row of TERMINATED padding
  alone (NaN denominators) and rows half deleted;
* "mid_pad": TERMINATED padding at lanes inside each row, not only after
  its last doc;
* "invalid": about 40% of the cache form's rows not valid, holding real
  docs;
* "no_alive": no deletes; the cache form gets `alive` None;
* "sparse": 1 to 8 live docs a row, fewer than kk = 10 or 128, so most
  slots are -inf lanes with their own docs.
K8 kinds (`tail_case`), one launch's [W, kk] per-row candidates with a
qid and a segment a row, rows of qid = num_queries (padding) and -inf
lanes among them; `merge_tail_model` is K8's algorithm in numpy:
* "ties": six score levels, so equal scores straddle every cut, docs up to
  2^32 - 1 (the u32 order), and planted duplicate addresses of one query;
* "zeros": +0.0 and -0.0 (and +-1.0) in every query, one address at both
  zeros in rows of one query;
* "long": W = 4,096 rows, one query owning most of them (many tiles), one
  query owning none, docs from a small pool, so addresses repeat across
  tiles;
* "dups": the phrase-prefix shape, each query's rows a union-max
  expansion: many rows of one query over few docs, each address at
  several scores in rows of different tiles;
* "sparse": one to three live lanes a row and few rows a query, fewer
  hits than k;
* "ascending": W = 1,500 rows, one query owning most of them, every
  candidate above the one before it in row and lane order (all live): in
  that order every candidate beats the running threshold, so the buffer
  fills and the list is selected again and again within a tile;
* "prefix_ties": W = 1,200 rows, one query owning most of them (many
  tiles), all its candidates but three at one score in one segment over
  distinct docs: its tiles' k-th keys tie in their top 64 bits (score,
  segment) and differ in the third word (the doc), so at k > 3 the
  query's top-k reaches down to the shared key itself.
K6 kinds (`phrase_case`), each query a leader region and partner regions
whose docs hold planted aligned phrase positions among random ones:
* "leader_tf16": leader lanes at tf 16 (MAX_P), up to 16 matches a doc;
* "partner_tf256": partners at tf up to 256, some exactly 256, pw = 256;
* "window_1024": one leader row spread over a 1,100-row partner region,
  kw = 1,024: the window covers the first 1,024 rows only;
* "store_end": the store's last region holds tfs of 20-32 at pw = 32, so
  the position windows of its last docs run past the last position into
  the postore's 0xFFFFFFFF (-1) padding and past its end;
* "deleted": 40% of the docs deleted, 4 terms;
* "t8": 8 terms, the leader in the middle;
* "ties": one match in every lane's doc, one field-norm id and one weight:
  every live lane of a query ties;
* "stage_edges": one bigram whose leader rows spread over partner ranges
  of 1 row (every live lane in one row), 10, 11 and 12 rows (with the
  leader's own row: below, at and above the kernel's 12 staged rows), 511,
  512 and 513 rows (below, at and above its 512 staged `blk_last` words),
  and 3 rows with one live lane, kw = 1,024.
"""

from __future__ import annotations

import numpy as np

from ..postings.format import TERMINATED
from .fused_store import build_cstore_np
from .probe_scorer import _iter_bucket

KIND_MUST, KIND_SHOULD, KIND_MUST_NOT, KIND_ABSENT = 0, 1, 2, 3

GROUP_KINDS = ("ties", "t16", "wide", "oversized")
BOOL_KINDS = ("every_row", "store_end")
DEEP_KINDS = ("ladder_edge", "t16", "stage_edges")
PACKED_KINDS = ("widths", "no_freqs", "ties")
DENSE_KINDS = ("ties", "dead", "mid_pad", "invalid", "no_alive", "sparse")
TAIL_KINDS = ("ties", "zeros", "long", "dups", "sparse", "ascending",
              "prefix_ties")
PHRASE_KINDS = ("leader_tf16", "partner_tf256", "window_1024", "store_end",
                "deleted", "t8", "ties", "stage_edges")
_WIDTHS = (0, 1, 2, 4, 8, 16, 32)

#: items of every synthetic chunk
CHUNK_W = 64
_MAX_DOC = 1_000_000


def _store(regions, rng, dead: float, kill=()):
    """[NB, 384] u32 store holding each sorted doc array of `regions` as one
    term region starting on an 8-row boundary, with the docs `kill` deleted
    besides a random share `dead`; returns (cstore, region starts, region
    lengths in rows, the arrays it was built from: docs and tfs [NB, 128]
    u32, norm_ids, alive, cache)."""
    docs, tfs, starts, lens = [], [], [], []
    at = 0
    for d in regions:
        gap = (-at) % 8
        if gap:
            docs.append(np.full((gap, 128), TERMINATED, np.uint32))
            tfs.append(np.ones((gap, 128), np.uint32))
            at += gap
        nb = -(-len(d) // 128)
        block = np.full(nb * 128, TERMINATED, np.uint32)
        block[:len(d)] = d
        docs.append(block.reshape(nb, 128))
        tfs.append(rng.integers(1, 3, (nb, 128)).astype(np.uint32))
        starts.append(at)
        lens.append(nb)
        at += nb
    norm_ids = rng.integers(0, 2, _MAX_DOC).astype(np.uint8)
    alive = rng.random(_MAX_DOC) >= dead
    alive[np.asarray(kill, np.int64)] = False
    cache = np.resize(np.array([1.25, 2.5], np.float32), 256)
    docs, tfs = np.concatenate(docs), np.concatenate(tfs)
    cstore = build_cstore_np(docs, tfs, norm_ids, alive, cache)
    parts = dict(docs=docs, tfs=tfs, norm_ids=norm_ids, alive=alive,
                 cache=cache)
    return cstore, np.array(starts), np.array(lens), parts


def _sorted_docs(rng, n: int, pool=None) -> np.ndarray:
    pool = _MAX_DOC if pool is None else pool
    return np.sort(rng.choice(pool, n, replace=False)).astype(np.uint32)


def _partner(rng, n: int, lane) -> np.ndarray:
    """n sorted docs, half of them lane docs, so that probes find some."""
    own = rng.choice(lane, min(n // 2, len(lane)), replace=False)
    rest = np.setdiff1d(np.arange(_MAX_DOC, dtype=np.uint32), own)
    more = rng.choice(rest, n - len(own), replace=False)
    return np.sort(np.concatenate([own, more])).astype(np.uint32)


def _first_last(cstore, lo: int, hi: int):
    """First and last real doc of store rows [lo, hi)."""
    d = cstore[lo:hi, :128].astype(np.int64)
    return d[:, 0], np.where(d != TERMINATED, d, -1).max(axis=1)


def _span_rows(rng, part, spans, one_live: int):
    """Item rows over the sorted partner docs `part` (rows of 128): the
    item for span m takes the first doc of a partner row r0, the last of
    row r0 + m - 1 and 126 other docs between them, partner docs or not;
    the spans' rows follow one another after the partner's first row, so
    the items' docs ascend across them. Returns (the items' sorted docs, the
    docs to delete so that item `one_live` keeps only its first doc
    live)."""
    items, kill, r0 = [], [], 1
    for i, m in enumerate(spans):
        lo, hi = int(part[r0 * 128]), int(part[(r0 + m) * 128 - 1])
        mid = rng.choice(np.arange(lo + 1, hi, dtype=np.int64), 126,
                         replace=False)
        d = np.sort(np.concatenate([[lo, hi], mid])).astype(np.uint32)
        items.append(d)
        if i == one_live:
            kill.extend(d[1:])
        r0 += m
    return items, kill


def _stride(slots: int) -> int:
    stride = 8
    while stride < slots:
        stride *= 2
    return stride


def group_case(kind: str, seed: int = 0) -> dict:
    """One K1 launch chunk of `kind` (see the module note): `rows` [64,
    STRIDE] i32, `tables` (cl_weight, cl_kind, cl_shipped, req_must,
    req_should, row_th), the reference's `cl_start`/`cl_len` (which K1 does
    not read), `cstore` [NB, 384] u32, `num_prows`, `T` and the reference
    rung `kw` whose window holds every sub-window (None for
    "oversized")."""
    rng = np.random.default_rng(1000 + 17 * seed + GROUP_KINDS.index(kind))
    T = 16 if kind == "t16" else 2
    n_groups = {"ties": 4, "t16": 4, "wide": 8, "oversized": 2}[kind]
    kw = {"ties": 16, "t16": 32, "wide": 64, "oversized": None}[kind]
    n_lane = n_groups * 8 * 128
    if kind == "oversized":
        # member r of group g meets partner rows [a, a + 255), a = 600g +
        # 40r; its docs come from the last 40 of them (half hits), so
        # members ascend and every lane's row is far into its sub-window
        partner = _sorted_docs(rng, 1400 * 128)
        p_rows = partner.reshape(-1, 128)
        lane = []
        for g in range(n_groups):
            for r in range(8):
                b = 600 * g + 40 * r + 255
                pool = p_rows[b - 40:b].reshape(-1)
                hits = rng.choice(pool, 64, replace=False)
                span = np.arange(int(pool[0]), int(pool[-1]))
                miss = rng.choice(np.setdiff1d(span, pool), 64,
                                  replace=False)
                lane.append(np.sort(np.concatenate([hits, miss])))
        lane = np.concatenate(lane).astype(np.uint32)
        partners = [partner]
    else:
        lane = _sorted_docs(rng, n_lane)
        if kind == "ties":
            partners = [_partner(rng, n_lane, lane)]
        elif kind == "t16":
            partners = [_partner(rng, int(n_lane * f), lane)
                        for f in rng.uniform(0.3, 1.2, T - 1)]
        else:  # a partner 6x as dense: about 6 rows a member
            partners = [_partner(rng, 6 * n_lane, lane)]
    cstore, rstart, rlen, _ = _store([lane] + partners, rng,
                                  dead=0.0 if kind == "ties" else 0.05)
    A = 4 + T
    rows = np.zeros((CHUNK_W, _stride(4 + 9 * T)), np.int32)
    rows[:, 1] = 1  # padding groups: mask 0, prow = num_prows
    rows[:, 4:4 + T] = -1
    for g in range(n_groups):
        base = int(rstart[0]) + 8 * g
        rows[g, :4] = (base, 0, 0, 0xFF)
        first, last = _first_last(cstore, base, base + 8)
        for t in range(1, T):
            s, n = int(rstart[t]), int(rlen[t])
            if kind == "oversized":
                a = s + 600 * g + 40 * np.arange(8)
                b = a + 255
            else:
                # member r's sub-window: the partner rows its docs meet
                pf, pl = _first_last(cstore, s, s + n)
                a = s + np.searchsorted(pl, first)
                b = s + np.searchsorted(pf, last, side="right")
            b = np.clip(b, s + 1, s + n)
            a = np.clip(a, s, b - 1)
            jlo = (int(a.min()) // 8) * 8
            if kw is not None:
                # as the launch layer does: the rung's window stays inside
                # the store, and sub-windows end inside the window
                jlo = min(jlo, ((cstore.shape[0] - kw) // 8) * 8)
                b = np.minimum(b, jlo + kw)
            ln = np.maximum(b - a, 0)
            rows[g, 4 + t] = jlo
            rows[g, A + 8 * t:A + 8 * t + 8] = np.where(
                ln > 0, ((a - jlo) << 8) | ln, 0)
        if kind == "t16":
            # the own clause is probed too, in the member's own row
            rows[g, 4] = base
            rows[g, A:A + 8] = (np.arange(8) << 8) | 1
    cl_weight = np.zeros((2, T), np.float32)
    cl_kind = np.full((2, T), KIND_ABSENT, np.int32)
    cl_shipped = np.zeros((2, T), np.int32)
    cl_weight[0] = rng.integers(1, 4, T)
    cl_kind[0] = KIND_SHOULD
    if kind == "t16":
        cl_kind[0, 1:] = rng.choice([KIND_MUST, KIND_SHOULD, KIND_MUST_NOT],
                                    T - 1, p=[0.05, 0.85, 0.1])
        cl_weight[0, cl_kind[0] == KIND_MUST_NOT] = 0.0
    cl_shipped[0, 0] = 1
    req_must = np.array([(cl_kind[0] == KIND_MUST).sum(), 1 << 30], np.int32)
    req_should = np.array([1, 0], np.int32)
    row_th = np.full(2, -np.inf, np.float32)
    if kind == "t16":
        row_th[0] = 0.1 * float(cl_weight[0].sum())
    return dict(
        kind=kind, rows=rows, T=T, kw=kw, num_prows=1, n_groups=n_groups,
        tables=(cl_weight, cl_kind, cl_shipped, req_must, req_should, row_th),
        cl_start=np.zeros((2, T), np.int32), cl_len=np.zeros((2, T), np.int32),
        cstore=cstore,
    )


def bool_case(kind: str, kw: int = 64, seed: int = 0) -> dict:
    """One K3 launch chunk of `kind` at rung `kw` (see the module note):
    `rows` [64, STRIDE] i32 (items past the real ones have qid =
    num_queries), `tables` (cl_weight, cl_kind, cl_start, cl_len,
    cl_shipped, req_must, req_should), `cstore` [NB, 384] u32, `kw`, `T`
    and `num_queries`. Query q's own clause is item q's row, a one-row
    region; its partner clause is one region shared by every query, the
    store's last."""
    rng = np.random.default_rng(2000 + 17 * seed + BOOL_KINDS.index(kind)
                                + kw)
    T, Q = 2, 12
    kw8 = ((kw + 7) & ~7) + 8 if kw > 8 else max((kw + 7) & ~7, 8)
    # the partner region; its last row is partly padding
    n_rows = 70 if kind == "every_row" else 80
    partner = _sorted_docs(rng, n_rows * 128 - 77)
    p_rows = [partner[128 * r:128 * (r + 1)] for r in range(n_rows)]
    win0 = 0 if kind == "every_row" else n_rows - kw8
    others = np.setdiff1d(np.arange(_MAX_DOC, dtype=np.uint32), partner)
    items = []
    for _ in range(Q):
        # a doc of every window row (the region's last doc among them),
        # the rest docs that no partner row holds
        picks = [p_rows[r][rng.integers(0, len(p_rows[r]))]
                 for r in range(win0, n_rows - 1)] + [partner[-1]]
        miss = rng.choice(others, 128 - len(picks), replace=False)
        items.append(np.sort(np.concatenate([np.array(picks, np.uint32),
                                             miss])))
    cstore, rstart, rlen, _ = _store(items + [partner], rng, dead=0.1)
    nb = cstore.shape[0]
    cl_weight = np.zeros((Q + 1, T), np.float32)
    cl_kind = np.full((Q + 1, T), KIND_ABSENT, np.int32)
    cl_start = np.zeros((Q + 1, T), np.int32)
    cl_len = np.zeros((Q + 1, T), np.int32)
    cl_shipped = np.zeros((Q + 1, T), np.int32)
    req_must = np.zeros(Q + 1, np.int32)
    req_should = np.zeros(Q + 1, np.int32)
    req_must[Q] = 1 << 30
    rows = np.zeros((CHUNK_W, _stride(3 + 2 * T)), np.int32)
    rows[:, 1] = Q
    rows[:, 3:3 + T] = -1
    for q in range(Q):
        cl_start[q] = (rstart[q], rstart[-1])
        cl_len[q] = (rlen[q], rlen[-1])
        cl_kind[q] = (KIND_SHOULD, KIND_MUST if q % 3 == 0 else KIND_SHOULD)
        cl_weight[q] = rng.integers(1, 4, T)
        cl_shipped[q, 0] = 1
        req_must[q] = int((cl_kind[q] == KIND_MUST).sum())
        req_should[q] = 0 if req_must[q] else 1
        rows[q, :3] = (rstart[q], q, 0)
        rows[q, 4] = rstart[-1] if kind == "every_row" else nb - kw8
        rows[q, 3 + T:3 + 2 * T] = kw8
    return dict(kind=kind, rows=rows, T=T, kw=kw, num_queries=Q,
                tables=(cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                        req_must, req_should),
                cstore=cstore)


def deep_case(kind: str, seed: int = 0) -> dict:
    """One K4 launch chunk of `kind` (see the module note): `rows` [64, 3]
    i32 (bid, qid, lcl; items past the real ones have qid = num_queries),
    `tables` (cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_must,
    req_should), `cstore` [NB, 384] u32, `blk_last` [NB] u32 (each row's
    last doc, TERMINATED for a row without one), `n_iters` (the reference's
    search depth for the longest region), `T`, `num_queries` and `parts`,
    the arrays the store was built from. Query q's clause 0 is item q's own
    row, a one-row region; its other clauses are partner regions shared by
    every query. Each query has a second item, a row of the first partner
    region with that clause as its own."""
    rng = np.random.default_rng(4000 + 17 * seed + DEEP_KINDS.index(kind))
    if kind == "stage_edges":
        return _deep_stage_edges(rng, kind)
    if kind == "ladder_edge":
        T, Q = 3, 8
        # the first partner spans 2^(9-1) rows: the widest region the
        # search depth n_iters = 9 covers
        lens = [256, 40]
    else:
        T, Q = 16, 4
        lens = [int(n) for n in rng.integers(1, 300, T - 1)]
        lens[0] = 300
    partners = [_sorted_docs(rng, n * 128 - int(rng.integers(1, 100)))
                for n in lens]
    pool = np.setdiff1d(np.arange(_MAX_DOC, dtype=np.uint32),
                        np.concatenate(partners))
    items = []
    for q in range(Q):
        p0 = partners[0]
        # the first partner's first and last docs, a doc of every fourth
        # row, then docs of the other partners; the rest no partner holds
        # (the pool's first and last docs lie outside every region)
        picks = [p0[0], p0[-1], pool[0], pool[-1]]
        picks += [p0[r * 128 + int(rng.integers(0, 128))]
                  for r in range(1, lens[0] - 1, 4)]
        for part in partners[1:]:
            picks += list(rng.choice(part, 3, replace=False))
        picks = np.unique(np.array(picks, np.uint32))[:100]
        miss = rng.choice(np.setdiff1d(pool, picks), 128 - len(picks),
                          replace=False)
        items.append(np.sort(np.concatenate([picks, miss])))
    cstore, rstart, rlen, parts = _store(items + partners, rng, dead=0.1)
    # the store's rows, its padding rows after the last region included
    docs = parts["docs"] = cstore[:, :128]
    parts["tfs"] = cstore[:, 128:256]
    real = docs != TERMINATED
    blk_last = np.where(real.any(axis=1),
                        np.where(real, docs, 0).max(axis=1),
                        TERMINATED).astype(np.uint32)
    cl_weight = np.zeros((Q + 1, T), np.float32)
    cl_kind = np.full((Q + 1, T), KIND_ABSENT, np.int32)
    cl_start = np.zeros((Q + 1, T), np.int32)
    cl_len = np.zeros((Q + 1, T), np.int32)
    cl_shipped = np.zeros((Q + 1, T), np.int32)
    req_must = np.zeros(Q + 1, np.int32)
    req_should = np.zeros(Q + 1, np.int32)
    req_must[Q] = 1 << 30
    rows = np.zeros((CHUNK_W, 3), np.int32)
    rows[:, 1] = Q
    for q in range(Q):
        cl_start[q] = rstart[[q] + list(range(Q, Q + T - 1))]
        cl_len[q] = rlen[[q] + list(range(Q, Q + T - 1))]
        # few MUST clauses among 16, or no lane would meet them all
        kinds = rng.choice([KIND_MUST, KIND_SHOULD, KIND_MUST_NOT], T - 1,
                           p=[0.3, 0.5, 0.2] if T < 16 else [0.08, 0.8, 0.12])
        cl_kind[q] = [KIND_SHOULD] + list(kinds)
        if kind == "t16":
            # two clauses of terms the segment lacks: empty regions
            cl_kind[q, -2:] = KIND_ABSENT
            cl_len[q, -2:] = 0
        cl_weight[q] = rng.integers(1, 4, T)
        cl_weight[q, cl_kind[q] > KIND_SHOULD] = 0.0
        cl_shipped[q, 0] = 1
        cl_shipped[q, 1] = q % 2
        req_must[q] = int((cl_kind[q] == KIND_MUST).sum())
        req_should[q] = 0 if req_must[q] else 1
        rows[q] = (rstart[q], q, 0)
        rows[Q + q] = (rstart[Q] + int(rng.integers(0, lens[0])), q, 1)
    return dict(kind=kind, rows=rows, T=T, num_queries=Q,
                n_iters=_iter_bucket(int(cl_len.max())),
                tables=(cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                        req_must, req_should),
                cstore=cstore, blk_last=blk_last, parts=parts)


#: "stage_edges" partner spans of K4's items, in rows; the last keeps one
#: live lane
_DEEP_SPANS = (1, 2047, 2048, 2049, 3)


def _deep_stage_edges(rng, kind: str) -> dict:
    """`deep_case("stage_edges")`: query q's clause 0 is item q's own row
    (a one-row region), clause 1 a partner region shared by every query
    (MUST for even q, SHOULD for odd q), whose rows the item's live docs
    span by `_DEEP_SPANS`."""
    T, Q = 2, len(_DEEP_SPANS)
    n_rows = sum(_DEEP_SPANS) + 3
    part = _sorted_docs(rng, n_rows * 128 - 50)
    items, kill = _span_rows(rng, part, _DEEP_SPANS, Q - 1)
    cstore, rstart, rlen, parts = _store(items + [part], rng, dead=0.0,
                                         kill=kill)
    docs = parts["docs"] = cstore[:, :128]
    parts["tfs"] = cstore[:, 128:256]
    real = docs != TERMINATED
    blk_last = np.where(real.any(axis=1),
                        np.where(real, docs, 0).max(axis=1),
                        TERMINATED).astype(np.uint32)
    cl_weight = np.zeros((Q + 1, T), np.float32)
    cl_kind = np.full((Q + 1, T), KIND_ABSENT, np.int32)
    cl_start = np.zeros((Q + 1, T), np.int32)
    cl_len = np.zeros((Q + 1, T), np.int32)
    cl_shipped = np.zeros((Q + 1, T), np.int32)
    req_must = np.zeros(Q + 1, np.int32)
    req_should = np.zeros(Q + 1, np.int32)
    req_must[Q] = 1 << 30
    rows = np.zeros((CHUNK_W, 3), np.int32)
    rows[:, 1] = Q
    for q in range(Q):
        cl_start[q] = (rstart[q], rstart[Q])
        cl_len[q] = (rlen[q], rlen[Q])
        cl_kind[q] = (KIND_SHOULD, KIND_MUST if q % 2 == 0 else KIND_SHOULD)
        cl_weight[q] = rng.integers(1, 4, T)
        cl_shipped[q, 0] = 1
        req_must[q] = int(q % 2 == 0)
        req_should[q] = 1 - req_must[q]
        rows[q] = (rstart[q], q, 0)
    return dict(kind=kind, rows=rows, T=T, num_queries=Q,
                n_iters=_iter_bucket(int(cl_len.max())),
                tables=(cl_weight, cl_kind, cl_start, cl_len, cl_shipped,
                        req_must, req_should),
                cstore=cstore, blk_last=blk_last, parts=parts)


def _packed_rows(rng, bits: int, top_bit: bool) -> np.ndarray:
    """[128] u32 values of width `bits` (top-bit-heavy when asked)."""
    if bits == 0:
        return np.zeros(128, np.uint32)
    hi = 1 << bits
    vals = rng.integers(hi // 2 if top_bit else 0, hi, 128, dtype=np.uint64)
    return vals.astype(np.uint32)


def packed_case(kind: str, seed: int = 0) -> dict:
    """One K5 launch chunk of `kind` (see the module note): `mirror`, the
    numpy arrays of a `device_index.PackedMirror` (doc_words and tf_words
    u32, blk_tab [NB, 8] i32, norm_ids u8, alive bool), `blocks` and
    `qids` [64] i32 (items past the real ones have qid = num_queries),
    `weights` [Q + 1] f32, `caches` [Q + 1, 256] f32 and `num_queries`."""
    from ..common import bitpack
    from ..query.bm25 import compute_tf_cache

    rng = np.random.default_rng(3000 + 17 * seed + PACKED_KINDS.index(kind))
    max_doc = 40_000
    freqs = kind == "widths"
    # (doc width, length, base, tf width); tf widths cycle over _WIDTHS
    spec = []
    for i, w in enumerate(_WIDTHS):
        for length in (128, int(rng.integers(1, 128))):
            span = 128 << w if w <= 8 else 0
            base = int(rng.integers(0, max(max_doc - span - 128, 1)))
            spec.append((w, length, base, _WIDTHS[(i + length) % 7]))
    spec.append((0, 100, max_doc - 100, 1))     # last doc max_doc - 1
    dead_base = int(rng.integers(0, max_doc - 128))
    spec.append((0, 128, dead_base, 2))         # every doc deleted
    doc_words, tf_words, tab = [], [], []
    n_doc = n_tf = 0
    for w, length, base, tw in spec:
        tw = tw if freqs else 0
        deltas = _packed_rows(rng, w, top_bit=w >= 16)
        tfs = _packed_rows(rng, tw, top_bit=tw == 32)
        doc_words.append(bitpack.pack_rows(deltas[None], w).reshape(-1))
        tf_words.append(bitpack.pack_rows(tfs[None], tw).reshape(-1))
        tab.append((n_doc, w, n_tf, tw, base, length, 0, 0))
        n_doc += 4 * w
        n_tf += 4 * tw
    norm_ids = rng.integers(0, 256 if freqs else 2, max_doc).astype(np.uint8)
    if kind == "ties":
        norm_ids[:] = 0
    alive = rng.random(max_doc) >= 0.1
    alive[dead_base:dead_base + 128] = False
    mirror = (np.concatenate(doc_words).astype(np.uint32),
              np.concatenate(tf_words).astype(np.uint32),
              np.array(tab, np.int32), norm_ids, alive)
    Q = 6
    nb = len(spec)
    items = [(b, int(rng.integers(0, Q))) for b in range(nb)]
    items += [(b, int(rng.integers(0, Q))) for b in rng.choice(nb, 8)]
    items += [(0, 0), (0, 0), (3, 1), (3, 1), (3, 1)]   # repeated blocks
    blocks = np.zeros(CHUNK_W, np.int32)
    qids = np.full(CHUNK_W, Q, np.int32)
    blocks[:len(items)], qids[:len(items)] = zip(*items)
    weights = rng.uniform(0.5, 3.0, Q + 1).astype(np.float32)
    if not freqs:
        weights[:] = weights[0]
    if kind == "ties":
        weights[:2] = (0.0, -0.0)
    caches = np.stack([compute_tf_cache(np.float32(a))
                       for a in rng.uniform(5.0, 60.0, Q + 1)])
    return dict(kind=kind, mirror=mirror, blocks=blocks, qids=qids,
                weights=weights, caches=caches.astype(np.float32),
                num_queries=Q)


def dense_case(kind: str, seed: int = 0) -> dict:
    """One K7 launch chunk of `kind` (see the module note) in both forms:
    `cstore` [NB, 384] u32 (the store form's rows), `rows` [64] int64 and
    `qids` [64] i32 (items past the real ones have qid = num_queries and
    real rows), `weights` [Q + 1] f32, and for the cache form `docs` and
    `tfs` [64, 128] u32 (the items' rows), `valid` [64] bool, `norm_ids`
    u8, `alive` (bool, or None for "no_alive") and `caches` [Q + 1, 256]
    f32; `parts` holds the arrays the store was built from."""
    from ..query.bm25 import compute_tf_cache

    rng = np.random.default_rng(4000 + 17 * seed + DENSE_KINDS.index(kind))
    max_doc, nb, Q = 40_000, 40, 6
    docs = np.full((nb, 128), TERMINATED, np.uint32)
    tfs = np.ones((nb, 128), np.uint32)
    for b in range(nb):
        n = 128 if kind in ("ties", "no_alive") else int(rng.integers(1, 129))
        if kind == "sparse":
            n = int(rng.integers(1, 9))
        docs[b, :n] = _sorted_docs(rng, n, max_doc)
        if kind != "ties":
            tfs[b, :n] = rng.integers(1, 4, n)
    if kind == "mid_pad":
        hole = rng.random((nb, 128)) < 0.3
        docs[hole] = TERMINATED
    if kind == "dead":
        docs[1] = TERMINATED
    norm_ids = rng.integers(0, 256, max_doc).astype(np.uint8)
    if kind == "ties":
        norm_ids[:] = 0
    alive = rng.random(max_doc) >= 0.1
    if kind == "dead":
        real = docs[docs != TERMINATED].astype(np.int64)
        alive[docs[0][docs[0] != TERMINATED].astype(np.int64)] = False
        alive[real[::2]] = False
    elif kind == "sparse":
        alive[docs[::2, 0].astype(np.int64)] = False
    cache = compute_tf_cache(np.float32(rng.uniform(5.0, 60.0)))
    store_alive = None if kind == "no_alive" else alive
    cstore = build_cstore_np(docs, tfs, norm_ids, store_alive, cache)
    items = [(b, int(rng.integers(0, Q))) for b in range(nb)]
    items += [(int(b), int(rng.integers(0, Q))) for b in rng.choice(nb, 8)]
    items += [(0, 0), (0, 0), (1, 1), (1, 1), (3, 2)]   # repeated rows
    rows = rng.integers(0, nb, CHUNK_W).astype(np.int64)  # padding: real rows
    qids = np.full(CHUNK_W, Q, np.int32)
    rows[:len(items)], qids[:len(items)] = zip(*items)
    valid = np.ones(CHUNK_W, bool)
    if kind == "invalid":
        valid = rng.random(CHUNK_W) >= 0.4
    weights = rng.uniform(0.5, 3.0, Q + 1).astype(np.float32)
    if kind == "ties":
        weights[:] = weights[0]
        weights[:2] = (0.0, -0.0)
    caches = np.stack([compute_tf_cache(np.float32(a))
                       for a in rng.uniform(5.0, 60.0, Q + 1)])
    return dict(kind=kind, num_queries=Q, cstore=cstore, rows=rows,
                qids=qids, weights=weights, docs=docs[rows], tfs=tfs[rows],
                valid=valid, norm_ids=norm_ids,
                alive=None if kind == "no_alive" else alive,
                caches=caches.astype(np.float32),
                parts=dict(docs=docs, tfs=tfs, norm_ids=norm_ids,
                           alive=store_alive, cache=cache))


#: per K6 kind: terms, queries, the leader's index, probe rows kw and
#: position window pw, leader rows, partner rows, leader and partner tf
#: ranges [lo, hi), position span, the share of deleted docs
_PHRASE_CFG = {
    "leader_tf16": dict(T=2, Q=4, lead=0, kw=8, pw=16, lead_rows=2,
                        part_rows=6, lead_tf=(12, 17), part_tf=(8, 17),
                        span=4096, dead=0.1),
    "partner_tf256": dict(T=3, Q=4, lead=1, kw=8, pw=256, lead_rows=2,
                          part_rows=6, lead_tf=(1, 5), part_tf=(200, 257),
                          span=8192, dead=0.1),
    "window_1024": dict(T=2, Q=2, lead=1, kw=1024, pw=16, lead_rows=1,
                        part_rows=1100, lead_tf=(1, 4), part_tf=(1, 4),
                        span=4096, dead=0.1),
    "store_end": dict(T=2, Q=4, lead=0, kw=64, pw=32, lead_rows=2,
                      part_rows=10, lead_tf=(1, 9), part_tf=(20, 33),
                      span=4096, dead=0.1),
    "deleted": dict(T=4, Q=4, lead=2, kw=8, pw=16, lead_rows=2, part_rows=4,
                    lead_tf=(1, 6), part_tf=(1, 9), span=4096, dead=0.4),
    "t8": dict(T=8, Q=3, lead=5, kw=64, pw=32, lead_rows=1, part_rows=3,
               lead_tf=(1, 6), part_tf=(1, 9), span=4096, dead=0.1),
    "ties": dict(T=2, Q=4, lead=0, kw=8, pw=16, lead_rows=2, part_rows=4,
                 lead_tf=(1, 2), part_tf=(1, 2), span=4096, dead=0.0),
    "stage_edges": dict(T=2, Q=1, lead=0, kw=1024, pw=16, lead_tf=(1, 5),
                        part_tf=(1, 7), span=4096, dead=0.0),
}
#: "stage_edges" partner spans of K6's leader rows, in rows; the last keeps
#: one live lane
_PHRASE_SPANS = (1, 10, 11, 12, 511, 512, 513, 3)


def _edge_terms(rng, cfg):
    """The "stage_edges" bigram: [(docs, tfs, per-doc positions)] of the
    leader (term 0, its rows from `_span_rows`) and the partner, and the
    docs to delete. Seven in ten leader docs the partner holds get a
    planted match (the partner holds a leader position plus one)."""
    n_rows = sum(_PHRASE_SPANS) + 3
    part = _sorted_docs(rng, n_rows * 128 - 50)
    items, kill = _span_rows(rng, part, _PHRASE_SPANS,
                             len(_PHRASE_SPANS) - 1)
    lead = np.concatenate(items)
    out = []
    for docs, tf_range in ((lead, cfg["lead_tf"]), (part, cfg["part_tf"])):
        tf = rng.integers(*tf_range, len(docs))
        pos = [np.sort(rng.choice(cfg["span"] - 1, n, replace=False))
               for n in tf]
        out.append([docs, tf, pos])
    where = {int(d): i for i, d in enumerate(part)}
    for i, d in enumerate(lead):
        j = where.get(int(d))
        if j is not None and rng.random() < 0.7:
            want = out[0][2][i][int(rng.integers(0, out[0][1][i]))] + 1
            pos = out[1][2][j]
            if want not in pos:
                pos[0] = want
                out[1][2][j] = np.sort(pos)
    return ([(d, np.asarray(tf, np.uint32), pos) for d, tf, pos in out],
            kill)


def _phrase_terms(rng, cfg, ties: bool):
    """One query's regions, [(docs, tfs, per-doc positions)] in term
    order. The docs every term holds get planted phrase matches: term t at
    s + t for starts s taken from the leader's positions."""
    T, lead = cfg["T"], cfg["lead"]
    n_part = cfg["part_rows"] * 128 - 29
    if cfg["lead_rows"] == 1 and cfg["part_rows"] > 64:
        # one leader row whose docs spread over the whole partner region
        part = _sorted_docs(rng, n_part)
        lead_docs = part[::len(part) // 128][:128]
        docs = {t: part for t in range(T) if t != lead}
    else:
        lead_docs = _sorted_docs(rng, cfg["lead_rows"] * 128 - 37)
        docs = {}
        for t in range(T):
            if t != lead:
                keep = lead_docs[rng.random(len(lead_docs))
                                 < (1.0 if ties else 0.8)]
                more = _sorted_docs(rng, max(n_part - len(keep), 1))
                docs[t] = np.union1d(keep, more).astype(np.uint32)
    docs[lead] = lead_docs
    tf = {t: rng.integers(*cfg["lead_tf" if t == lead else "part_tf"],
                          len(docs[t]))
          for t in range(T)}
    if cfg["lead_tf"][1] > 16:
        tf[lead][::2] = 16  # every other leader doc at MAX_P
    span = cfg["span"]
    where = {t: {int(d): i for i, d in enumerate(docs[t])} for t in range(T)}
    pos = {t: [None] * len(docs[t]) for t in range(T)}
    for i, d in enumerate(lead_docs):
        lp = np.sort(rng.choice(np.arange(T, span), tf[lead][i],
                                replace=False))
        pos[lead][i] = lp
        holds = [where[t].get(int(d)) for t in range(T)]
        m = 0
        if all(h is not None for h in holds):
            cap = min(int(tf[t][holds[t]]) for t in range(T))
            m = 1 if ties else int(rng.integers(0, cap + 1))
        starts = rng.choice(lp, m, replace=False) - lead
        for t in range(T):
            if t != lead and holds[t] is not None:
                need = starts + t
                free = np.setdiff1d(np.arange(span), need)
                fill = rng.choice(free, int(tf[t][holds[t]]) - m,
                                  replace=False)
                pos[t][holds[t]] = np.sort(np.concatenate([need, fill]))
    for t in range(T):
        # the other docs: ascending positions by random gaps of at least 1
        rest = [i for i, p in enumerate(pos[t]) if p is None]
        n = tf[t][rest]
        gaps = rng.integers(1, max(2, span // max(int(n.max(initial=1)), 1)),
                            int(n.sum()))
        cum = np.cumsum(gaps)
        first = np.repeat(np.cumsum(n) - n, n)
        runs = np.split(cum - np.append(0, cum)[first], np.cumsum(n)[:-1])
        for i, p in zip(rest, runs):
            pos[t][i] = p
    return [(docs[t], np.asarray(tf[t], np.uint32), pos[t])
            for t in range(T)]


def phrase_case(kind: str, seed: int = 0) -> dict:
    """One K6 launch chunk of `kind` (see the module note), for the port
    and for the reference's `probe_phrase_topk`: `rows` [64, 3] i32 (bid,
    qid, leader term; items past the real ones have qid = num_queries),
    `tables` (q_weight [Q+1] f32, cl_start / cl_len / cl_shift [Q+1, T]
    i32), the reference's `cl_pos_start`, `cstore` [NB, 384] u32,
    `postore` [NPr, 256] u32 (positions | owners, 0xFFFFFFFF padding),
    `blk_pos` [NB + 1] i64, `blk_last` [NB] u32, `kw`, `pw`, `n_iters`,
    `T`, `num_queries` and `parts`: the store's docs and tfs, norm_ids,
    alive, cache, the flat positions and their per-lane exclusive tf sums
    (`pos_cum`), as the reference's field store holds them. Every leader
    block of each query is an item."""
    rng = np.random.default_rng(6000 + 17 * seed + PHRASE_KINDS.index(kind))
    cfg = _PHRASE_CFG[kind]
    T, Q, lead = cfg["T"], cfg["Q"], cfg["lead"]
    ties = kind == "ties"
    docs, tfs, starts, lens, flat_pos = [], [], [], [], []
    kill = []
    if kind == "stage_edges":
        edge, kill = _edge_terms(rng, cfg)
    at = 0
    for _ in range(Q):
        terms = edge if kind == "stage_edges" else _phrase_terms(rng, cfg,
                                                                 ties)
        for d, tf, pos in terms:
            gap = (-at) % 8
            if gap:
                docs.append(np.full((gap, 128), TERMINATED, np.uint32))
                tfs.append(np.ones((gap, 128), np.uint32))
                at += gap
            nb = -(-len(d) // 128)
            block = np.full(nb * 128, TERMINATED, np.uint32)
            block[:len(d)] = d
            tblock = np.ones(nb * 128, np.uint32)
            tblock[:len(d)] = tf
            docs.append(block.reshape(nb, 128))
            tfs.append(tblock.reshape(nb, 128))
            flat_pos.extend(pos)
            starts.append(at)
            lens.append(nb)
            at += nb
    norm_ids = (np.zeros(_MAX_DOC, np.uint8) if ties
                else rng.integers(0, 2, _MAX_DOC).astype(np.uint8))
    alive = rng.random(_MAX_DOC) >= cfg["dead"]
    alive[np.asarray(kill, np.int64)] = False
    cache = np.resize(np.array([1.25, 2.5], np.float32), 256)
    cstore = build_cstore_np(np.concatenate(docs), np.concatenate(tfs),
                             norm_ids, alive, cache)
    store_docs, store_tfs = cstore[:, :128], cstore[:, 128:256]
    real = store_docs != TERMINATED
    real_tf = np.where(real, store_tfs, 0).reshape(-1)
    pos_cum = (np.cumsum(real_tf, dtype=np.uint32) - real_tf).astype(
        np.uint32)
    positions = np.concatenate(flat_pos).astype(np.uint32)
    n_pos = len(positions)
    rows_p = -(-n_pos // 128)
    pad = np.full(rows_p * 128 - n_pos, 0xFFFFFFFF, np.uint32)
    owners = np.repeat(store_docs.reshape(-1), real_tf)
    postore = np.concatenate(
        [np.concatenate([positions, pad]).reshape(rows_p, 128),
         np.concatenate([owners, pad]).reshape(rows_p, 128)], axis=1)
    blk_pos = np.append(pos_cum[::128].astype(np.int64), n_pos)
    blk_last = np.where(real.any(axis=1),
                        np.where(real, store_docs, 0).max(axis=1),
                        TERMINATED).astype(np.uint32)
    starts = np.array(starts).reshape(Q, T)
    lens = np.array(lens).reshape(Q, T)
    q_weight = (np.full(Q + 1, 1.75, np.float32) if ties
                else rng.uniform(1.0, 3.0, Q + 1).astype(np.float32))
    cl_start = np.zeros((Q + 1, T), np.int32)
    cl_len = np.zeros((Q + 1, T), np.int32)
    cl_shift = np.zeros((Q + 1, T), np.int32)
    cl_start[:Q], cl_len[:Q] = starts, lens
    cl_shift[:Q] = (T - 1) - np.arange(T)
    cl_pos_start = pos_cum[cl_start.astype(np.int64) * 128].astype(np.int32)
    rows = np.zeros((CHUNK_W, 3), np.int32)
    rows[:, 1] = Q
    items = [(starts[q, lead] + r, q, lead)
             for q in range(Q) for r in range(lens[q, lead])]
    rows[:len(items)] = items
    return dict(kind=kind, rows=rows, T=T, num_queries=Q, kw=cfg["kw"],
                pw=cfg["pw"], n_iters=_iter_bucket(int(cl_len.max())),
                tables=(q_weight, cl_start, cl_len, cl_shift),
                cl_pos_start=cl_pos_start, cstore=cstore, postore=postore,
                blk_pos=blk_pos, blk_last=blk_last,
                parts=dict(docs=store_docs, tfs=store_tfs,
                           norm_ids=norm_ids, alive=alive, cache=cache,
                           positions=positions, pos_cum=pos_cum))


def tail_case(kind: str, kk: int = 32, seed: int = 0) -> dict:
    """One K8 call of `kind` (see the module note): `row_sc` [W, kk] f32,
    `row_doc` [W, kk] u32 (TERMINATED on -inf lanes), `row_seg` [W] i32,
    `qid` [W] i32 (num_queries on padding rows) and `num_queries`."""
    rng = np.random.default_rng(8000 + 31 * seed + TAIL_KINDS.index(kind))
    W, Q, n_docs, n_seg = 300, 12, 400, 4
    if kind == "long":
        W, Q, n_docs = 4096, 8, 3000
    elif kind == "dups":
        W, Q, n_docs, n_seg = 1200, 6, 150, 3
    elif kind == "sparse":
        W, Q = 40, 16
    elif kind == "ascending":
        W, Q, n_docs = 1500, 3, 1 << 20
    elif kind == "prefix_ties":
        W, Q, n_docs = 1200, 4, 1 << 20
    levels = rng.uniform(0.5, 9.0, 6).astype(np.float32)
    sc = levels[rng.integers(0, len(levels), (W, kk))]
    if kind in ("long", "dups"):
        sc = rng.uniform(0.5, 9.0, (W, kk)).astype(np.float32)
    if kind == "ascending":
        sc = (1.0 + 1e-4 * np.arange(W * kk)).astype(np.float32).reshape(
            W, kk)
    if kind == "prefix_ties":
        sc = np.full((W, kk), 5.0, np.float32)
    if kind == "zeros":
        sc = np.array([0.0, -0.0, 1.0, -1.0, 0.0, -0.0],
                      np.float32)[rng.integers(0, 6, (W, kk))]
    dc = rng.integers(0, n_docs, (W, kk)).astype(np.uint32)
    if kind == "ties":
        dc[rng.random((W, kk)) < 0.2] += np.uint32(0xFFFF0000)
    seg = rng.integers(0, n_seg, W).astype(np.int32)
    qid = rng.integers(0, Q, W).astype(np.int32)
    if kind == "long":
        qid = np.where(rng.random(W) < 0.9, 3, qid)
        qid[qid == 5] = 6           # query 5 owns no row
    if kind in ("ascending", "prefix_ties"):
        qid = np.where(rng.random(W) < 0.9, 0, qid)
    if kind == "prefix_ties":
        seg = np.where(qid == 0, 1, seg).astype(np.int32)
        # three candidates above the tie, fewer than k = 10
        top = rng.choice(np.flatnonzero(qid == 0), 3, replace=False)
        sc[top, rng.integers(0, kk, 3)] = np.float32(7.5)
    qid[rng.random(W) < 0.08] = Q   # padding rows
    dead = rng.random((W, kk)) < (
        0.0 if kind in ("sparse", "ascending") else
        0.02 if kind == "prefix_ties" else 0.25)
    if kind == "sparse":
        dead = np.ones((W, kk), bool)
        for w in range(W):
            dead[w, rng.choice(kk, int(rng.integers(1, 4)), replace=False)] = (
                False)
    # duplicate addresses of one query, planted row against row, at the
    # same score or another
    for _ in range(W // 4 if kind not in ("ascending", "prefix_ties")
                   else W // 50):
        a, b = rng.integers(0, W, 2)
        qid[b], seg[b] = qid[a], seg[a]
        j, i = rng.integers(0, kk, 2)
        dc[b, i] = dc[a, j]
        dead[b, i] = dead[a, j]
        sc[b, i] = (sc[a, j] if rng.random() < 0.5 or kind == "prefix_ties"
                    else levels[rng.integers(0, len(levels))])
    if kind == "zeros":
        # one address at both zeros, in two rows of query 0
        qid[:2], seg[:2], dead[:2, 0] = 0, 1, False
        dc[:2, 0] = 7
        sc[0, 0], sc[1, 0] = np.float32(-0.0), np.float32(0.0)
    sc[dead] = -np.inf
    dc[dead] = TERMINATED
    return dict(kind=kind, row_sc=sc, row_doc=dc, row_seg=seg, qid=qid,
                num_queries=Q)


#: K8's constants (`csrc/merge_tail.cu`): candidates a tile holds (R * kk)
#: and its most rows, candidates a round (kThreads * kPer), the least and
#: the largest shared-memory sort array
TAIL_TILE_CANDS = 8192
TAIL_MAX_TILE_ROWS = 1024
TAIL_ROUND = 512
TAIL_MIN_SORT = 1024
TAIL_SMEM_MAX_SORT = 8192
#: the largest k whose sort arrays K8 keeps in shared memory
TAIL_SMEM_MAX_K = TAIL_SMEM_MAX_SORT - TAIL_ROUND
#: the calls K8's small kernel takes: at most these candidates, rows and
#: (query, row) pairs
TAIL_SMALL_CANDS = 16384
TAIL_SMALL_ROWS = 2048
TAIL_SMALL_SCAN = 1 << 22
_NEG_INF_BITS = 0xFF800000
_M32 = 0xFFFFFFFF
#: the model's mutations, each a fault `merge_tail_model` must be caught by
TAIL_MUTATIONS = ("dedup", "final_filter", "flush")


def tail_tile_rows(kk: int) -> int:
    """Rows of one of K8's tiles at `kk`."""
    return min(TAIL_MAX_TILE_ROWS, TAIL_TILE_CANDS // kk)


def tail_small(n_rows: int, kk: int, k: int, num_queries: int) -> bool:
    """Whether K8 takes a call of this shape with its small kernel."""
    return (tail_sort_size(k) <= TAIL_SMEM_MAX_SORT
            and n_rows * kk <= TAIL_SMALL_CANDS
            and n_rows <= TAIL_SMALL_ROWS
            and n_rows * num_queries <= TAIL_SMALL_SCAN)


def tail_sort_size(k: int) -> int:
    """Entries of K8's sort array at `k` (in global scratch above
    TAIL_SMEM_MAX_SORT)."""
    s = 1
    while s < k + TAIL_ROUND:
        s <<= 1
    return max(s, TAIL_MIN_SORT)


def _image(bits):
    """`merge_tail.cu`'s score_image: order-keeping, one image a bit
    pattern."""
    bits = np.asarray(bits, np.uint64)
    return np.where(bits & 0x80000000, ~bits & _M32, bits | 0x80000000)


def _image_bits(x):
    x = np.asarray(x, np.uint64)
    return np.where(x & 0x80000000, x & 0x7FFFFFFF, ~x & _M32)


def _gt(e, th):
    """Each entry's 96-bit key (columns 0-2) above `th`'s."""
    x, y, z = e[:, 0], e[:, 1], e[:, 2]
    return (x > th[0]) | ((x == th[0]) & (
        (y > th[1]) | ((y == th[1]) & (z > th[2]))))


def _prefix(e):
    return (e[:, 0] << np.uint64(32)) | e[:, 1]


class _TailSel:
    """A CTA's running top-k as K8 keeps it: `lst` the list, best first,
    `buf` the candidates appended since the last selection ([n, 4] uint64:
    score image, key words 1 and 2, 1 for a candidate), `th` the list's
    k-th entry once it holds k, `gth` the query's shared key."""

    def __init__(self, k: int, seg: bool, mutate=None):
        self.k, self.seg, self.mutate = k, seg, mutate
        self.S = tail_sort_size(k)
        self.lst = np.zeros((0, 4), np.uint64)
        self.buf = []
        self.n = 0
        self.gth = 0
        self.selections = 0

    def must_select(self) -> bool:
        len_, n, k = len(self.lst), self.n, self.k
        if self.mutate == "flush":
            return len_ < k and 0 < n and len_ + n >= k
        return len_ + n + TAIL_ROUND > self.S or (
            len_ < k and n > 0 and len_ + n >= k)

    def offer(self, ents, final_filter=False) -> None:
        """One round's real candidates: those that beat the thresholds
        join the buffer (`final_filter`: the cross-tile merge's filter on
        the final shared key)."""
        pre = _prefix(ents)
        g = np.uint64(self.gth)
        ok = (pre > g) if final_filter and self.mutate == "final_filter" \
            else pre >= g
        if len(self.lst) == self.k:
            ok &= _gt(ents, self.lst[-1])
        ents = ents[ok]
        if self.mutate == "flush":
            ents = ents[:max(0, self.S - len(self.lst) - self.n)]
        if len(ents):
            self.buf.append(ents)
            self.n += len(ents)

    def select(self) -> None:
        """Sort list and buffer descending; the seg form keeps the first
        entry of each address; the first k are the new list."""
        self.selections += 1
        a = np.concatenate([self.lst] + self.buf)
        assert len(a) <= self.S, "the buffer overflowed its sort array"
        a = a[np.lexsort((a[:, 3], a[:, 2], a[:, 1], a[:, 0]))[::-1]]
        if self.seg:
            addr = (a[:, 1] << np.uint64(32)) | a[:, 2]
            if self.mutate == "dedup":
                _, last = np.unique(addr[::-1], return_index=True)
                keep = np.sort(len(a) - 1 - last)
            else:
                _, keep = np.unique(addr, return_index=True)
                keep = np.sort(keep)
            a = a[keep]
        self.lst = a[:self.k]
        self.buf, self.n = [], 0

    def top_prefix(self) -> int:
        return int(_prefix(self.lst[-1:])[0])


def _run_rounds(sel, ents, real, final_filter=False, after_select=None,
                after_round=None):
    """K8's `run_select` on one tile's (or one query's tile lists')
    candidates in order, a generator yielding after each round."""
    for f0 in range(0, len(ents), TAIL_ROUND):
        if sel.must_select():
            sel.select()
            if after_select:
                after_select()
        r = real[f0:f0 + TAIL_ROUND]
        sel.offer(ents[f0:f0 + TAIL_ROUND][r], final_filter)
        if after_round:
            after_round()
        yield
    if sel.n > 0:
        sel.select()
        if after_select:
            after_select()


def merge_tail_model(row_sc, row_doc, row_seg, qid, k: int,
                     num_queries: int, seed=0, mutate=None,
                     stats=None) -> np.ndarray:
    """K8's algorithm in numpy (`csrc/merge_tail.cu`), its arithmetic as the
    card runs it: a call that `tail_small` admits as the small kernel runs
    it (each query's rows in row order, one tile); any other as the grid
    kernel: the group pass (each query's rows in an order drawn from
    `seed`, as the scatter's atomics leave them; row order when `seed` is
    None), tiles of `tail_tile_rows(kk)` rows, rounds of TAIL_ROUND
    candidates, the filter against the list's k-th entry and the query's
    shared key, the selections over list and buffer (when the next round
    might not fit the sort array, or the list can be filled; the seg form
    keeping each address's first entry in sorted order), the tiles of a
    query run interleaved round by round in an order drawn from `seed`
    (in turn when None), publishing their k-th key prefix at each
    selection and reading the shared key after each round, and the
    cross-tile merge of the tile lists filtered on the final shared key.
    `row_seg` None is the rows form. `mutate` (one of TAIL_MUTATIONS)
    plants a fault: "dedup" keeps each address's last entry, "final_filter"
    drops tile-list entries whose top 64 bits equal the shared key,
    "flush" never selects for room and drops what the buffer cannot hold.
    `stats`, a dict, gets the selections run and the queries merged across
    tiles. Returns the packed [2 or 3, Q, k] int32 result."""
    rng = np.random.default_rng(seed) if seed is not None else None
    seg_form = row_seg is not None
    W, kk = row_sc.shape
    R = tail_tile_rows(kk)
    bits = np.ascontiguousarray(row_sc, np.float32).view(np.uint32)
    docs = np.ascontiguousarray(row_doc).view(np.uint32).astype(np.uint64)
    img = _image(bits)
    ones = np.ones((W, kk), np.uint64)
    if seg_form:
        segs = np.broadcast_to(
            (~np.asarray(row_seg).astype(np.uint64) & _M32)[:, None],
            (W, kk))
        ents = np.stack([img, segs, ~docs & _M32, ones], axis=-1)
    else:
        ents = np.stack([img, ~docs & _M32, np.full((W, kk), _M32,
                                                    np.uint64), ones],
                        axis=-1)
    real = bits != _NEG_INF_BITS
    out = np.zeros((3 if seg_form else 2, num_queries, k), np.uint64)
    out[0] = _NEG_INF_BITS
    n_sel = n_multi = 0

    small = tail_small(W, kk, k, num_queries)
    for q in range(num_queries):
        rows = np.flatnonzero(qid == q)
        if small:
            # the small kernel: the query's rows in row order, one tile
            tiles = [rows]
        else:
            if rng is not None:
                rows = rng.permutation(rows)
            tiles = [rows[t:t + R] for t in range(0, len(rows), R)] or [rows]
        sels = [_TailSel(k, seg_form, mutate) for _ in tiles]
        if len(tiles) == 1:
            t = tiles[0]
            for _ in _run_rounds(sels[0], ents[t].reshape(-1, 4),
                                 real[t].reshape(-1)):
                pass
            final = sels[0]
        else:
            n_multi += 1
            shared = [0]

            def publisher(sel):
                def publish():
                    if len(sel.lst) == k:
                        shared[0] = max(shared[0], sel.top_prefix())
                return publish

            def reader(sel):
                def read():
                    sel.gth = max(sel.gth, shared[0])
                return read

            runs = [_run_rounds(sel, ents[t].reshape(-1, 4),
                                real[t].reshape(-1), False,
                                publisher(sel), reader(sel))
                    for sel, t in zip(sels, tiles)]
            live = list(range(len(runs)))
            while live:
                i = (live[int(rng.integers(len(live)))] if rng is not None
                     else live[0])
                if next(runs[i], StopIteration) is StopIteration:
                    live.remove(i)
            pad = np.zeros((0, 4), np.uint64)
            lists = np.concatenate([
                np.concatenate([sel.lst, np.zeros(
                    (k - len(sel.lst), 4), np.uint64)]) for sel in sels
            ] + [pad])
            final = _TailSel(k, seg_form, mutate)
            final.gth = shared[0]
            for _ in _run_rounds(final, lists, lists[:, 3] != 0, True):
                pass
            n_sel += final.selections
        n_sel += sum(sel.selections for sel in sels)
        lst = final.lst
        m = len(lst)
        out[0, q, :m] = _image_bits(lst[:, 0])
        if seg_form:
            out[1, q, :m] = ~lst[:, 2] & _M32
            out[2, q, :m] = ~lst[:, 1] & _M32
        else:
            out[1, q, :m] = ~lst[:, 1] & _M32
    if stats is not None:
        stats.update(selections=n_sel, merged_queries=n_multi)
    return out.astype(np.uint32).view(np.int32)
