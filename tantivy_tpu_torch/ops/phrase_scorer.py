"""Per-segment phrase (slop 0) probe (kernel K6): the planner's constants,
the CUDA kernel's wrapper, its plain PyTorch twin and the per-segment
dispatch.

Counterpart of `tantivy_tpu/ops/phrase_scorer.py` (which imports jax at
the top, so its constants are copied here). The reference's XLA program
`probe_phrase_topk` (`:71`) becomes kernel K6, `csrc/seg_phrase.cu`; the
kernel source holds a note on its design. A phrase query is an
intersection whose tf is the number of aligned position matches: the work
items are the rarest (leader) term's posting blocks, each lane's doc is
probed in every term's region through a `kw`-row window, then the doc's
positions are compared.

Inputs, per launch chunk of W work items (one item = one cstore row of the
leader term's region, for one query):
* `rows` [W, 3] i32: 0=bid (cstore row), 1=qid (num_queries = padding),
  2=the leader term's index in the query;
* `q_weight` [Qp] f32, the phrase's BM25 weight; `cl_start` / `cl_len`
  [Qp, T] i32, each term's region in cstore rows; `cl_shift` [Qp, T] i32,
  the alignment shift (largest offset minus the term's offset);
* `cstore` [NB, 384] i32 (docs | tfs | bitcast(cachev), NaN = dead or pad),
  `blk_last` [NB] i32, each row's last doc;
* `postore` [NPr, 256] i32 (positions | owners) and `blk_pos` [NB + 1] i32,
  the global index of each row's first position.

A lane reports when its doc is live, every term holds it and at least one
of the leader's first MAX_P positions aligns with a position of every
other term among that term's first `pw`; its score is
`q_weight * tf / (tf + cachev)` with tf that count. Output: per item its
top-kk reporting lanes, scores [W, kk] f32 and docs [W, kk] i32, ordered
(score desc, lane asc); -inf / TERMINATED fill.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..postings.format import TERMINATED
from ..utils.trace import debug_time
from .merge_tail import topk_from_rows
from .probe_scorer import (
    binsearch_flat,
    check_tensor,
    group_topk,
)

#: max phrase terms on the device path
T_MAX = 8
#: leader in-doc tf cap: (query, segment) plans whose leader blocks hold a
#: larger tf resolve on the host
MAX_P = 16
#: position-window rungs (any term's in-doc tf cap), each with the W cap
#: that bounds the reference's gathered [W, 128, pw] windows; the port
#: takes only the rungs (K6 builds no such windows, its twin slices its
#: items to bound them)
_PW_LADDER = ((16, 16384), (32, 8192), (64, 4096), (256, 1024))
#: beyond the widest rung the (query, segment) resolves on the host
MAX_OTHER_TF = _PW_LADDER[-1][0]
_ITER_LADDER = (9, 15, 21)
#: window elements the twin gathers per term at once: it scores its items
#: in slices whose doc windows (128 * kw an item) and position windows
#: (128 * pw) hold at most this many
_TWIN_WINDOW = 1 << 24

#: columns of a launch row: bid, qid, leader term
ROW_COLS = 3

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()


def _iter_bucket(max_region_len: int) -> int:
    for it in _ITER_LADDER:
        if max_region_len <= (1 << (it - 1)):
            return it
    raise AssertionError(f"posting region too long: {max_region_len}")


def _pw_bucket(max_tf: int) -> int:
    for pw, _ in _PW_LADDER:
        if max_tf <= pw:
            return pw
    raise AssertionError(f"in-doc tf beyond device cap: {max_tf}")


def _window_probe(cstore, blk_last, blk_pos, docs, s, n, kw: int,
                  n_iters: int):
    """The reference's `probe_term_window` over the fused store, for one
    term: the window starts at the lower bound of each item's first doc
    among the region's row last docs (`n_iters` fixed binary steps) and
    spans `kw` rows, cut to the region and the store. Returns (found, tf,
    pbase) [W, 128]: whether each lane's doc is in the window, its tf and
    the global index of its first position (the row's `blk_pos` plus the
    tfs of the row's earlier lanes)."""
    w = docs.shape[0]
    nb = cstore.shape[0]
    end = torch.clamp(s + n, max=nb)
    jlo = binsearch_flat(blk_last, docs[:, 0].long(), s, end, n_iters)
    rows = jlo[:, None] + torch.arange(kw, device=docs.device)[None, :]
    row_ok = rows < end[:, None]
    rows_safe = rows.clamp(max=nb - 1)
    win = torch.where(row_ok[:, :, None], cstore[rows_safe, :128],
                      int(TERMINATED)).reshape(w, kw * 128)
    # rows of one region ascend, and TERMINATED (the largest int32) pads
    # only the region's last row and the rows past it: `win` is sorted
    p = torch.searchsorted(win, docs.contiguous()).clamp(max=kw * 128 - 1)
    found = win.gather(1, p) == docs
    wtf = cstore[rows_safe, 128:256]
    tf = wtf.reshape(w, kw * 128).gather(1, p)
    excl = (torch.cumsum(wtf.long(), dim=2) - wtf).reshape(w, kw * 128)
    row = rows_safe.gather(1, p // 128)
    pbase = blk_pos[row].long() + excl.gather(1, p)
    return found, tf, pbase


def seg_phrase_ref(rows, q_weight, cl_start, cl_len, cl_shift, cstore,
                   postore, blk_pos, blk_last, *, num_queries: int, kk: int,
                   kw: int, pw: int, n_iters: int):
    """Plain PyTorch version of the kernel: the reference's XLA program
    written in torch. Each term's windowed probe (`_window_probe`), its
    [W, 128, pw] position window, then for each of the leader's first
    MAX_P positions a compare against every term's window; `q_weight *
    tf / (tf + cachev)` of the count; each item's top-kk reporting lanes
    by (score desc, lane asc). Items are independent: the twin scores them
    in slices whose windows hold at most `_TWIN_WINDOW` elements a term."""
    step = max(1, _TWIN_WINDOW // (128 * max(kw, pw)))
    if rows.shape[0] > step:
        parts = [seg_phrase_ref(rows[lo:lo + step], q_weight, cl_start,
                                cl_len, cl_shift, cstore, postore, blk_pos,
                                blk_last, num_queries=num_queries, kk=kk,
                                kw=kw, pw=pw, n_iters=n_iters)
                 for lo in range(0, rows.shape[0], step)]
        return (torch.cat([sc for sc, _ in parts]),
                torch.cat([d for _, d in parts]))
    r = rows.long()
    w = r.shape[0]
    nb = cstore.shape[0]
    Qp, T = cl_start.shape
    bid, q, lead = r[:, 0], r[:, 1], r[:, 2]
    live = (q >= 0) & (q < num_queries) & (bid >= 0) & (bid < nb)
    qc = q.clamp(0, Qp - 1)
    own = cstore[bid.clamp(0, max(nb - 1, 0))]
    docs = own[:, :128]
    cachev = own[:, 256:].view(torch.float32)
    all_found = live[:, None] & (docs != TERMINATED) & ~torch.isnan(cachev)
    npos = postore.shape[0] * 128
    jj = torch.arange(pw, device=docs.device)
    start, length = cl_start[qc].long(), cl_len[qc].long()
    shift = cl_shift[qc]
    tf_t, win_t = [], []
    for t in range(T):
        found, tf, pbase = _window_probe(cstore, blk_last, blk_pos, docs,
                                         start[:, t], length[:, t], kw,
                                         n_iters)
        all_found &= found & (length[:, t] > 0)[:, None]
        pidx = (pbase[:, :, None] + jj).clamp(0, npos - 1)
        win = postore[pidx >> 7, pidx & 127]
        tf_t.append(tf)
        win_t.append(torch.where(jj < tf[:, :, None], win, -(1 << 30)))
    # anchor on the lane's own (leader) term
    lead = lead.clamp(0, T - 1)
    anchor_tf, anchor_win = tf_t[0], win_t[0]
    for t in range(1, T):
        is_t = (lead == t)[:, None]
        anchor_tf = torch.where(is_t, tf_t[t], anchor_tf)
        anchor_win = torch.where(is_t[:, :, None], win_t[t], anchor_win)
    anchor_shift = shift.gather(1, lead[:, None])
    count = torch.zeros_like(docs)
    for j in range(MAX_P):
        p = anchor_win[:, :, j] + anchor_shift
        match = (j < anchor_tf) & all_found
        for t in range(T):
            target = (p - shift[:, t, None])[:, :, None]
            match &= (win_t[t] == target).any(dim=2)
        count += match.int()
    tf = count.float()
    score = q_weight[qc][:, None] * (tf / (tf + cachev))
    lane_scores = torch.where(all_found & (count > 0), score, float("-inf"))
    th = torch.full((w,), float("-inf"), device=docs.device)
    return group_topk(lane_scores, docs, th, kk)


def seg_phrase(rows, q_weight, cl_start, cl_len, cl_shift, cstore, postore,
               blk_pos, blk_last, *, num_queries: int, kk: int, kw: int,
               pw: int, n_iters: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] i32).

    CUDA tensors launch the kernel, whose searches are exact (so `n_iters`
    is the twin's only); CPU tensors take `seg_phrase_ref`."""
    global launches
    dev = rows.device
    check_tensor("rows", rows, torch.int32, 2, dev)
    check_tensor("q_weight", q_weight, torch.float32, 1, dev)
    Qp = q_weight.shape[0]
    check_tensor("cl_start", cl_start, torch.int32, 2, dev)
    T = cl_start.shape[1]
    for name, x in (("cl_len", cl_len), ("cl_shift", cl_shift)):
        check_tensor(name, x, torch.int32, 2, dev)
    for name, x in (("cl_start", cl_start), ("cl_len", cl_len),
                    ("cl_shift", cl_shift)):
        if tuple(x.shape) != (Qp, T):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(Qp, T)}")
    for name, x, ndim in (("cstore", cstore, 2), ("postore", postore, 2),
                          ("blk_pos", blk_pos, 1), ("blk_last", blk_last, 1)):
        check_tensor(name, x, torch.int32, ndim, dev)
    if rows.shape[1] != ROW_COLS:
        raise ValueError(f"launch rows hold {rows.shape[1]} columns, not "
                         f"{ROW_COLS}")
    if cstore.shape[1] != 384:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} words, not 384")
    if postore.shape[1] != 256:
        raise ValueError(f"postore rows hold {postore.shape[1]} words, not "
                         "256")
    if blk_last.shape[0] != cstore.shape[0]:
        raise ValueError(f"blk_last has {blk_last.shape[0]} rows, cstore "
                         f"{cstore.shape[0]}")
    if blk_pos.shape[0] != cstore.shape[0] + 1:
        raise ValueError(f"blk_pos has {blk_pos.shape[0]} entries, want "
                         f"{cstore.shape[0] + 1}")
    if postore.shape[0] * 128 >= 2**31:
        raise ValueError("postore positions do not fit int32 indices")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{T} terms outside 1..{T_MAX}")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if not 1 <= kw < 2**31 or not MAX_P <= pw <= MAX_OTHER_TF:
        raise ValueError(f"kw={kw} or pw={pw} out of range")
    if not 0 <= num_queries < Qp:
        raise ValueError(
            f"num_queries={num_queries} outside the {Qp}-row tables"
        )
    args = (rows, q_weight, cl_start, cl_len, cl_shift, cstore, postore,
            blk_pos, blk_last)
    if dev.type == "cpu":
        return seg_phrase_ref(*args, num_queries=num_queries, kk=kk, kw=kw,
                              pw=pw, n_iters=n_iters)
    if dev.type != "cuda":
        raise ValueError(f"seg_phrase runs on cuda or cpu, not {dev}")
    lib = _lib()
    W = rows.shape[0]
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_phrase_launch(
            rows.data_ptr(), W, T, q_weight.data_ptr(), cl_start.data_ptr(),
            cl_len.data_ptr(), cl_shift.data_ptr(), num_queries,
            cstore.data_ptr(), blk_last.data_ptr(), cstore.shape[0],
            postore.data_ptr(), postore.shape[0], blk_pos.data_ptr(), kw, pw,
            kk, out_sc.data_ptr(), out_doc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"seg_phrase kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def seg_phrase_topk(rows, tables, cstore, postore, blk_pos, blk_last, *,
                    k: int, num_queries: int, kw: int, pw: int,
                    n_iters: int, rec: dict | None = None):
    """One launch chunk end to end: the kernel (its twin on the CPU) with
    item top-kk, kk = min(k, 128), then the per-query merge (kernel K8's
    rows form, `merge_tail.topk_from_rows`, which takes `rec`). `tables` = (q_weight, cl_start, cl_len, cl_shift). Returns
    packed [2, Q, k] i32 (score bits | doc)."""
    sc, docs = seg_phrase(rows, *tables, cstore, postore, blk_pos, blk_last,
                          num_queries=num_queries, kk=min(k, 128), kw=kw,
                          pw=pw, n_iters=n_iters)
    return topk_from_rows(sc, docs, rows[:, 1].contiguous(), k, num_queries,
                          rec=rec)


def dispatch_phrase(fused, slab, work_blocks, work_qid, work_term, tables,
                    k: int, num_queries: int, work_width, log=None,
                    count=None):
    """Launch one (segment, field, term count) group's leader-block work
    list of one phase (at least one item): one launch, at kw = the next power of two of its
    widest item's window (`work_width`, in rows) and the position-window
    rung of its items' largest query tf (`tables["q_max_tf"]`). K6 narrows
    each item's rows to its live docs' range, so neither a wide item nor a
    wide kw costs the other items anything, and it gathers no window: the
    reference's kw rungs, its split by position-window rung and its W caps
    bounded the [W, kw * 128] and [W, 128, pw] windows XLA gathers. Its
    lanes read a term's first min(tf, pw) positions with pw at least that
    tf, so the results do not depend on the split. Nor does it pad chunks:
    the kernel takes the real items.

    Planning works in the slab's own block ids; the slab's `offset` moves
    block ids and regions into the fused store's rows. `tables` = q_weight
    [Q+1] and cl_start / cl_len / cl_shift [Q+1, T] numpy arrays and
    q_max_tf [Q+1]. When `log` is a list, the launch's exact inputs are
    appended to it (kind="seg_phrase"); `count("phrase_seg")` is called
    once per launch. Returns packed [2, Q, k] i32 on the store's device."""
    off = slab["offset"]
    # one store tensor of each kind for the whole call (another batch may
    # replace them with grown copies meanwhile; rows only append)
    cstore = fused.cstore
    postore, blk_pos = fused.position_tensors()
    blk_pos = blk_pos[:cstore.shape[0] + 1]
    blk_last = fused.blk_last_device()[:cstore.shape[0]]
    dev = cstore.device
    T = tables["cl_start"].shape[1]
    n_iters = _iter_bucket(int(tables["cl_len"].max(initial=1)))
    with debug_time("phrase_seg.tables"):
        targs = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (
                tables["q_weight"].astype(np.float32),
                (tables["cl_start"].astype(np.int64) + off).astype(np.int32),
                tables["cl_len"].astype(np.int32),
                tables["cl_shift"].astype(np.int32),
            )
        )
    kw = 1 << int(np.ceil(np.log2(max(int(np.max(work_width)), 1))))
    pw = _pw_bucket(int(tables["q_max_tf"][work_qid].max()))
    rows = np.stack([work_blocks + off, work_qid, work_term],
                    axis=1).astype(np.int32)
    rows_t = torch.from_numpy(rows).to(dev)
    rec = None
    if log is not None:
        rec = dict(
            kind="seg_phrase", rows=rows_t, tables=targs, cstore=cstore,
            postore=postore, blk_pos=blk_pos, blk_last=blk_last, k=k,
            num_queries=num_queries, kw=kw, pw=pw, n_iters=n_iters,
            n_terms=T,
        )
        log.append(rec)
    with debug_time("phrase_seg.launch", n=len(rows)):
        out = seg_phrase_topk(
            rows_t, targs, cstore, postore, blk_pos, blk_last, k=k,
            num_queries=num_queries, kw=kw, pw=pw, n_iters=n_iters,
            rec=rec,
        )
    if count is not None:
        count("phrase_seg")
    return out


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("seg_phrase")
    if lib.seg_phrase_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.seg_phrase_launch.argtypes = [
            p, i, i,               # rows, n_items, n_terms
            p, p, p, p, i,         # q_weight, cl_start, cl_len, cl_shift, Q
            p, p, ll,              # cstore, blk_last, store rows
            p, ll, p,              # postore, postore rows, blk_pos
            i, i, i,               # kw, pw, kk
            p, p, p,               # out_scores, out_docs, stream
        ]
        lib.seg_phrase_launch.restype = ctypes.c_int
    return lib
