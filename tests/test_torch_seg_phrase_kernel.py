"""Kernel K6, the per-segment phrase probe (`ops/phrase_scorer.py`): its
plain twin against the reference's XLA `phrase_scorer.probe_phrase_topk` on
the synthetic hard cases of `ops/kernel_cases.py` (also at a kw narrower
than some lanes' rows and at one wider than the reference's MAX_KW), a
numpy emulation of the kernel's first design (its window search, position
lookup and cursor count) against the twin, the smoke's sector count for
K6 against a lane-by-lane count of the work and against what that design
loaded, the wrapper's checks, and (`cuda` marker) the kernel against the
twin on the card.

Every comparison feeds both sides the same inputs, made from a seed with
numpy. Scores are compared as f32 bits, docs exactly."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops import phrase_scorer as ref_ph
from tantivy_tpu.postings.format import TERMINATED
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops import phrase_scorer as ph

from test_torch_deep_probe import _lower_bound4

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script)

KKS = [1, 10, 128]


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _port(case, device="cpu"):
    """A `phrase_case` as the wrapper takes it: (rows, tables, cstore,
    postore, blk_pos, blk_last) tensors."""
    return (_t(case["rows"], device),
            tuple(_t(a, device) for a in case["tables"]),
            _t(case["cstore"].view(np.int32), device),
            _t(case["postore"].view(np.int32), device),
            _t(case["blk_pos"].astype(np.int32), device),
            _t(case["blk_last"].view(np.int32), device))


def _kw(case, kk, kw=None):
    return dict(num_queries=case["num_queries"], kk=kk,
                kw=case["kw"] if kw is None else kw, pw=case["pw"],
                n_iters=case["n_iters"])


#: (kind, kw) pairs at another window width than the case's: narrower than
#: some lanes' rows (the window still clips them) and wider than the
#: reference's MAX_KW of 1,024 rows
OTHER_KW = [("stage_edges", 4), ("window_1024", 64), ("stage_edges", 2048)]


@pytest.fixture(scope="module")
def cases():
    return {kind: kc.phrase_case(kind) for kind in kc.PHRASE_KINDS}


@pytest.mark.parametrize("kind,k,kw",
                         [(kind, 10, None) for kind in kc.PHRASE_KINDS]
                         + [(kind, k, None) for kind in ("leader_tf16", "ties")
                            for k in (1, 200)]
                         + [(kind, 10, kw) for kind, kw in OTHER_KW])
def test_twin_matches_reference_on_hard_cases(cases, kind, k, kw):
    """`seg_phrase_topk` on the CPU (the twin and the merge tail) equals
    the reference's XLA `probe_phrase_topk` bit for bit, each given the
    same leader blocks and tables: the reference reads its field store
    (docs, tfs, per-lane `pos_cum`, flat positions, norm ids, alive), the
    port the fused-store form of the same data."""
    case = cases[kind]
    if kw is not None:
        case = {**case, "kw": kw}
    parts, Q = case["parts"], case["num_queries"]
    b, q, lead = case["rows"].T
    q_weight, cl_start, cl_len, cl_shift = case["tables"]
    want = np.asarray(ref_ph.probe_phrase_topk(
        jnp.asarray(parts["docs"][b]), jnp.asarray(q), jnp.asarray(lead),
        jnp.asarray(q < Q), jnp.asarray(parts["docs"]),
        jnp.asarray(parts["tfs"]), jnp.asarray(case["blk_last"]),
        jnp.asarray(parts["pos_cum"]), jnp.asarray(parts["positions"]),
        jnp.asarray(parts["norm_ids"]), jnp.asarray(parts["alive"]),
        jnp.asarray(parts["cache"]), q_weight, cl_start, cl_len,
        case["cl_pos_start"], cl_shift, k=k, num_queries=Q,
        n_terms=case["T"], kw=case["kw"], n_iters=case["n_iters"],
        pw=case["pw"],
    ))
    rows, tables, cstore, postore, blk_pos, blk_last = _port(case)
    got = ph.seg_phrase_topk(rows, tables, cstore, postore, blk_pos,
                             blk_last, k=k, num_queries=Q, kw=case["kw"],
                             pw=case["pw"], n_iters=case["n_iters"])
    assert np.array_equal(got.numpy().view(np.uint32), want)
    scores = want[0].view(np.float32)
    assert np.isfinite(scores).sum() >= min(k, 10) * Q // 2


# -- a numpy emulation of the kernel, step for step -------------------------


def _probe_window_at(st, a, b, doc, words):
    """row_probe.cuh's `probe_window_at` fence search over rows [a, b):
    the row it settles on; the cstore word of each fence goes to
    `words`."""
    row, n = a, b - a
    while n > 1:
        q = (n + 3) >> 2
        k = 0
        for i in (1, 2, 3):
            if i * q < n:
                words.append((row + i * q) * 384)
                k += int(st[row + i * q, 0] <= doc)
        row += k * q
        n = min(q, n - k * q)
    return row


def _probe_row_at(st, row, doc, words):
    """`probe_row_at`: (found, tf, lane); each word loaded goes to
    `words` (the pivots, the octet's 8 docs and 8 tfs)."""
    base = 0
    for span in (32, 8):
        idx = [base + i * span - 1 for i in (1, 2, 3)]
        words.extend(row * 384 + i for i in idx)
        base += span * sum(int(st[row, i] < doc) for i in idx)
    words.extend(row * 384 + base + i for i in range(8))
    words.extend(row * 384 + 128 + base + i for i in range(8))
    for i in range(8):
        if st[row, base + i] == doc:
            return True, int(st[row, 128 + base + i]), base + i
    return False, 0, 0


def _match_count(case, q, lead, tf, pb, load):
    """The kernel's count for one lane every term holds (tf, pb per term):
    a forward cursor per other term over the leader's first min(tf, MAX_P)
    positions, in term order until none is left matching; `load(i)` reads
    flat position i."""
    q_weight, cl_start, cl_len, cl_shift = case["tables"]
    jmax = min(tf[lead], ph.MAX_P)
    lp = [load(pb[lead] + j) for j in range(jmax)]
    mask = (1 << jmax) - 1
    for t in range(case["T"]):
        if mask == 0:
            break
        if t == lead:
            continue
        lim = min(tf[t], case["pw"])
        c = 0
        cur = load(pb[t]) if lim > 0 else 0
        m = 0
        for j in range(jmax):
            target = lp[j] + int(cl_shift[q, lead] - cl_shift[q, t])
            while c < lim and cur < target:
                c += 1
                if c < lim:
                    cur = load(pb[t] + c)
            if c < lim and cur == target:
                m |= 1 << j
        mask &= m
    return bin(mask).count("1")


def _position_loader(case, psec):
    pos = case["postore"].view(np.int32).reshape(-1)
    n_pos = case["postore"].shape[0] * 128

    def load(i):
        i = min(max(i, 0), n_pos - 1)
        w = (i >> 7) * 256 + (i & 127)
        psec.add(w // 8)
        return int(pos[w])

    return load


def _items(case):
    """(bid, q, leader, live lanes) of each real item of the chunk."""
    st = case["cstore"].view(np.int32)
    nb, T, Q = st.shape[0], case["T"], case["num_queries"]
    for bid, q, lead in case["rows"]:
        if not (0 <= q < Q and 0 <= bid < nb):
            yield None
            continue
        cachev = st[bid, 256:].view(np.float32)
        lanes = [lane for lane in range(128)
                 if st[bid, lane] != TERMINATED and not np.isnan(cachev[lane])]
        yield int(bid), int(q), min(max(int(lead), 0), T - 1), lanes


def emulate(case, k=10):
    """K6's first design on one chunk, lane by lane (a 4-ary search from
    the item's first doc for each term's window, then per lane and term a
    fence search and a row probe, the position index from `blk_pos` and
    the row's earlier tfs, the forward cursor count): (per item the
    reporting lanes as (score, lane, doc), the distinct 32-byte sectors it
    loads: a dict of sets for cstore, blk_last, blk_pos and postore)."""
    st = case["cstore"].view(np.int32)
    bl = case["blk_last"].view(np.int32)
    blk_pos = case["blk_pos"]
    q_weight, cl_start, cl_len, cl_shift = case["tables"]
    nb, T = st.shape[0], case["T"]
    kw = case["kw"]
    cwords, last, bp, psec = [], set(), set(), set()
    load = _position_loader(case, psec)
    out = []
    for item in _items(case):
        reps = []
        out.append(reps)
        if item is None:
            continue
        bid, q, lead, lanes = item
        cwords.extend(bid * 384 + i for i in range(128))
        cwords.extend(bid * 384 + 256 + i for i in range(128))
        win = []
        for t in range(T):
            s, n = int(cl_start[q, t]), int(cl_len[q, t])
            e = min(s + n, nb)
            if n > 0 and s >= 0 and e > s:
                keys = []
                lo = _lower_bound4(bl, s, e - s, st[bid, 0], keys)
                last.update(i // 8 for i in keys)
                win.append((lo, min(lo + kw, e)))
            else:
                win.append((s, s))
        for lane in lanes:
            doc = st[bid, lane]
            tf, pb = [0] * T, [0] * T
            ok = True
            for t in range(T):
                a, b = win[t]
                if b <= a:
                    ok = False
                    break
                row = _probe_window_at(st, a, b, doc, cwords)
                found, tf[t], at = _probe_row_at(st, row, doc, cwords)
                if not found:
                    ok = False
                    break
                cwords.extend(row * 384 + 128 + i for i in range(at))
                bp.add(row // 8)
                pb[t] = int(blk_pos[row]) + int(st[row, 128:128 + at].sum())
            if not ok:
                continue
            count = _match_count(case, q, lead, tf, pb, load)
            if count:
                cf = np.float32(count)
                cachev = st[bid, 256 + lane:257 + lane].view(np.float32)[0]
                reps.append((q_weight[q] * (cf / (cf + cachev)), lane, doc))
    sectors = dict(cstore={w // 8 for w in cwords}, blk_last=last,
                   blk_pos=bp, postore=psec)
    return out, sectors


def needed_sectors(case) -> int:
    """K6's work on one chunk, lane by lane, as the distinct 32-byte
    sectors it needs whatever a kernel loads: each real item's docs and
    denominators; for each live lane and each term it reaches (in term
    order until one misses), the docs sector of the window row that holds
    its doc or would (the first whose last doc is at least it; none past
    the window) and, on a hit, its tf sector and `blk_pos` entry; for the
    lanes every term holds, the positions the cursor count reads."""
    st = case["cstore"].view(np.int32)
    bl = case["blk_last"].view(np.int32)
    blk_pos = case["blk_pos"]
    _, cl_start, cl_len, _ = case["tables"]
    nb, T, kw = st.shape[0], case["T"], case["kw"]
    csec, bp, psec = set(), set(), set()
    load = _position_loader(case, psec)
    for item in _items(case):
        if item is None:
            continue
        bid, q, lead, lanes = item
        csec.update(range(bid * 48, bid * 48 + 16))
        csec.update(range(bid * 48 + 32, bid * 48 + 48))
        win = []
        for t in range(T):
            s, n = int(cl_start[q, t]), int(cl_len[q, t])
            e = min(s + n, nb)
            lo = s
            if n > 0 and s >= 0 and e > s:
                lo = s + int(np.searchsorted(bl[s:e], st[bid, 0]))
            win.append((lo, min(lo + kw, e) if e > s else s))
        for lane in lanes:
            doc = st[bid, lane]
            tf, pb = [0] * T, [0] * T
            for t in range(T):
                lo, hi = win[t]
                row = lo + int(np.searchsorted(bl[lo:hi], doc))
                if row >= hi:
                    break
                at = int(np.searchsorted(st[row, :128], doc))
                csec.add(row * 48 + at // 8)
                if st[row, at] != doc:
                    break
                csec.add(row * 48 + 16 + at // 8)
                bp.add(row // 8)
                tf[t] = int(st[row, 128 + at])
                pb[t] = int(blk_pos[row]) + int(st[row, 128:128 + at].sum())
            else:
                _match_count(case, q, lead, tf, pb, load)
    return len(csec) + len(bp) + len(psec)


@pytest.mark.parametrize("kind", kc.PHRASE_KINDS)
def test_emulation_matches_twin(cases, kind):
    """The kernel's steps, emulated lane by lane in numpy (the 4-ary
    window search from the item's first doc, the fence and row probe, the
    position index from `blk_pos` and the row's earlier tfs, the forward
    cursor count over the leader's first MAX_P positions), give the twin's
    reporting lanes, scores (f32 bits) and order: (score desc, lane
    asc)."""
    case = cases[kind]
    reps, _ = emulate(case)
    rows, tables, *stores = _port(case)
    sc, dc = ph.seg_phrase_ref(rows, *tables, *stores, **_kw(case, 128))
    n_rep = 0
    for i, item in enumerate(reps):
        item.sort(key=lambda r: (-r[0], r[1]))
        n = len(item)
        n_rep += n
        want_sc = np.array([r[0] for r in item], np.float32)
        assert np.array_equal(sc[i, :n].numpy().view(np.int32),
                              want_sc.view(np.int32)), (kind, i)
        assert dc[i, :n].tolist() == [int(r[2]) for r in item]
        assert torch.isinf(sc[i, n:]).all()
        assert (dc[i, n:] == TERMINATED).all()
    assert n_rep > 20, "the case reports too little"
    if kind == "ties":
        live = sc[torch.isfinite(sc)]
        assert (live == live[0]).all() and n_rep == 128 * 8 - 37 * 4


def _smoke_rec(case):
    rows, tables, cstore, postore, blk_pos, blk_last = _port(case)
    rec = dict(cstore=cstore, postore=postore, blk_pos=blk_pos,
               blk_last=blk_last, tables=tables, k=10,
               num_queries=case["num_queries"], kw=case["kw"],
               pw=case["pw"])
    small = rows.numel() * 4 + sum(t.numel() * 4 for t in tables)
    return rec, rows, small + rows.shape[0] * 10 * 8


@pytest.mark.parametrize("kind", kc.PHRASE_KINDS)
def test_smoke_byte_count_is_the_sectors_k6_loads(cases, kind):
    """The smoke's byte count for K6 (`chip_smoke.seg_phrase_bytes`, all
    lanes at once in torch) is the distinct 32-byte sectors the work needs,
    counted lane by lane here (`needed_sectors`), plus the launch rows, the
    tables and the [W, kk] outputs: one bound for every build of K6."""
    case = cases[kind]
    rec, rows, small = _smoke_rec(case)
    assert chip_smoke.seg_phrase_bytes(rec, rows) == (
        32 * needed_sectors(case) + small)


@pytest.mark.parametrize("kind", kc.PHRASE_KINDS)
def test_smoke_byte_count_is_at_most_what_the_first_design_loads(cases,
                                                                 kind):
    """The work the bound counts is at most what K6's first design loaded,
    emulated lane by lane (`emulate`): it loaded every sector the work
    needs, and its searches' words besides."""
    case = cases[kind]
    _, sectors = emulate(case)
    rec, rows, small = _smoke_rec(case)
    first = 32 * sum(len(x) for x in sectors.values()) + small
    assert chip_smoke.seg_phrase_bytes(rec, rows) <= first
    assert len(sectors["blk_last"]) > 0


def test_twin_window_is_the_reference_window(cases):
    """The 1,024-row window covers the first 1,024 rows of the item's
    1,100-row partner region only: its lanes whose docs lie beyond are
    not found, in the twin as in the reference (the hard-case test), so
    fewer lanes report than the partner holds."""
    case = cases["window_1024"]
    q = 0
    lead = case["rows"][q, 2]
    part = 1 - lead
    s, n = case["tables"][1][q, part], case["tables"][2][q, part]
    assert n == 1100 and case["kw"] == 1024
    st = case["cstore"].view(np.int32)
    docs = st[case["rows"][q, 0], :128]
    beyond = docs > st[s + 1023, :128].max()
    assert beyond.sum() > 0
    rows, tables, *stores = _port(case)
    sc, dc = ph.seg_phrase_ref(rows, *tables, *stores, **_kw(case, 128))
    reported = set(dc[q][torch.isfinite(sc[q])].tolist())
    assert reported and not reported & set(docs[beyond].tolist())


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(cases):
    case = cases["deleted"]
    rows, tables, cstore, postore, blk_pos, blk_last = _port(case)
    kw = _kw(case, 10)
    n0 = ph.launches
    got = ph.seg_phrase(rows, *tables, cstore, postore, blk_pos, blk_last,
                        **kw)
    want = ph.seg_phrase_ref(rows, *tables, cstore, postore, blk_pos,
                             blk_last, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ph.launches == n0  # the twin does not count
    head = (rows, tables, cstore, postore, blk_pos, blk_last)
    bad = [
        ((rows.long(), *head[1:]), kw),
        ((torch.cat([rows, rows[:, :1]], 1), *head[1:]), kw),
        ((rows, tables, cstore[:, :256].contiguous(), *head[3:]), kw),
        ((rows, tables, cstore, postore[:, :128].contiguous(), *head[4:]),
         kw),
        ((*head[:4], blk_pos[:-1].contiguous(), blk_last), kw),
        ((*head[:5], blk_last[:-1].contiguous()), kw),
        ((rows, (tables[0], tables[1][:, :1].contiguous(), *tables[2:]),
          *head[2:]), kw),
        (head, {**kw, "kk": 129}),
        (head, {**kw, "pw": 8}),
        (head, {**kw, "kw": 0}),
        (head, {**kw, "kw": 2**31}),
        (head, {**kw, "num_queries": case["num_queries"] + 1}),
    ]
    for (r, tb, st, po, bp, bl), k in bad:
        with pytest.raises(ValueError):
            ph.seg_phrase(r, *tb, st, po, bp, bl, **k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kk", KKS)
@pytest.mark.parametrize("kind,window", [(kind, None)
                                         for kind in kc.PHRASE_KINDS]
                         + OTHER_KW)
def test_kernel_matches_twin_on_card(cuda_device, cases, kind, window, kk):
    """The kernel equals the twin bit for bit on each hard case at kk = 1,
    10 and 128, `stage_edges` holding ranges below, at and above the
    kernel's 12 staged rows and 512 staged `blk_last` words, an item whose
    live lanes all lie in one row and one with one live lane; also at kw
    narrower than some lanes' rows and wider than 1,024."""
    case = cases[kind]
    rows, tables, cstore, postore, blk_pos, blk_last = _port(case,
                                                             cuda_device)
    kw = _kw(case, kk, window)
    n0 = ph.launches
    got = ph.seg_phrase(rows, *tables, cstore, postore, blk_pos, blk_last,
                        **kw)
    want = ph.seg_phrase_ref(rows, *tables, cstore, postore, blk_pos,
                             blk_last, **kw)
    torch.cuda.synchronize()
    assert ph.launches == n0 + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
