"""Kernel K4, the deep per-lane boolean probe (`ops/deep_probe.py`): its
plain twin against the reference's XLA `probe_scorer.probe_bool_topk` on
the synthetic hard cases of `ops/kernel_cases.py`, a numpy emulation of
the kernel's first design (a 4-ary search over each whole clause region)
against the twin's fixed-depth binary search, the smoke's sector count
for K4 against a lane-by-lane count of the work and against what the
first design loaded, the launch rows `dispatch_probe` builds against the
inputs the reference hands its deep probe, the wrapper's checks, and
(`cuda` marker) the kernel against the twin on the card.

Every comparison feeds both sides the same inputs, made from a seed with
numpy. Scores are compared as f32 bits, docs exactly."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tantivy_tpu as tt
import tantivy_tpu.parallel as jax_par
from tantivy_tpu.ops import probe_scorer as ref_ps
from tantivy_tpu.postings.format import TERMINATED
from tantivy_tpu_torch import BatchExecutor
from tantivy_tpu_torch.ops import deep_probe as dp
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops import probe_scorer as ps

import zstd_stub
from test_torch_bool_probe import _Dfp, make_case
from test_torch_host_parity import port_searcher, to_port
from test_torch_probe_path import build_wide_index, t

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the repo root's smoke script)

KKS = [1, 10, 128]


@pytest.fixture(scope="module")
def wide_index():
    """`test_torch_probe_path`'s index whose windows reach the deep path,
    built and read with the zstandard stand-in where the package is
    missing (the card's machine)."""
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        yield build_wide_index()


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _hard(kind, device="cpu"):
    """A `deep_case` as the wrapper takes it: (rows, tables, cstore,
    blk_last, num_queries, n_iters)."""
    case = kc.deep_case(kind)
    return (_t(case["rows"], device),
            tuple(_t(a, device) for a in case["tables"]),
            _t(case["cstore"].view(np.int32), device),
            _t(case["blk_last"].view(np.int32), device),
            case["num_queries"], case["n_iters"])


def _random(T, device="cpu"):
    """`test_torch_bool_probe.make_case(64, T)` as deep launch rows, with
    the `blk_last` of its store's rows (padding rows included)."""
    case = make_case(64, T)
    rows = np.stack([case["bids"], case["qid"], case["lcl"]], axis=1)
    blk_last = _Dfp(case["cstore"][:, :128]).blk_last_doc
    return (_t(rows.astype(np.int32), device),
            tuple(_t(a, device) for a in case["tables"]),
            _t(case["cstore"].view(np.int32), device),
            _t(blk_last.view(np.int32), device),
            6, ps._iter_bucket(int(case["tables"][3].max())))


CASES = {**{kind: (lambda kind=kind, **kw: _hard(kind, **kw))
            for kind in kc.DEEP_KINDS},
         "random_T2": lambda **kw: _random(2, **kw),
         "random_T4": lambda **kw: _random(4, **kw)}


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("kind", kc.DEEP_KINDS)
def test_twin_matches_reference_on_hard_cases(kind, k):
    """`deep_probe_topk` on the CPU (the twin and the merge tail) equals
    the reference's XLA `probe_bool_topk` bit for bit, with the reference's
    own search depth: at the ladder's edge (a 256-row region, n_iters = 9),
    with 16 clauses, two of them empty, and with live docs spread over
    ranges below, at and above the kernel's staged `blk_last` cap."""
    case = kc.deep_case(kind)
    parts, Q = case["parts"], case["num_queries"]
    b, q, c = case["rows"].T
    cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_m, req_s = \
        case["tables"]
    docs, tfs = parts["docs"], parts["tfs"]
    want = ref_ps.probe_bool_topk(
        jnp.asarray(docs[b]), jnp.asarray(tfs[b]), jnp.asarray(q),
        jnp.asarray(c), jnp.asarray(q < Q), jnp.asarray(docs),
        jnp.asarray(tfs), jnp.asarray(case["blk_last"]),
        jnp.asarray(parts["norm_ids"]), jnp.asarray(parts["alive"]),
        jnp.asarray(parts["cache"]), cl_weight, cl_kind, cl_start, cl_len,
        cl_shipped.astype(bool), req_m, req_s, k=k, num_queries=Q,
        n_clauses=case["T"], n_iters=case["n_iters"],
    )
    rows, tables, cstore, blk_last, _, n_iters = _hard(kind)
    got = dp.deep_probe_topk(rows, tables, cstore, blk_last, k=k,
                             num_queries=Q, n_iters=n_iters)
    want = np.asarray(want)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # the case holds what it claims
    assert np.isfinite(want[0].view(np.float32)).sum() >= min(k, 10) * Q // 2
    if kind == "ladder_edge":
        assert cl_len.max() == 1 << (n_iters - 1)
    elif kind == "t16":
        assert case["T"] == 16 and (cl_len[:Q] == 0).any()
    else:
        assert cl_len[0, 1] > sum(kc._DEEP_SPANS)


def _lower_bound4(keys, lo, n, doc, reads=None):
    """The kernel's `lower_bound4`, step for step: 3 pivots a step, a
    quarter kept; the index of each key it loads goes to `reads`."""
    while n > 0:
        q = (n + 3) >> 2
        idx = [lo + i * q - 1 for i in (1, 2, 3) if i * q <= n]
        if reads is not None:
            reads.extend(idx)
        k = sum(int(keys[i] < doc) for i in idx)
        lo += k * q
        n = q - 1 if (k < 3 and (k + 1) * q <= n) else n - k * q
    return lo


def _probe_row(row, doc, reads=None):
    """row_probe.cuh's `probe_row`: the 32-doc block, the 8-doc octet, then
    the octet's docs; (found, tf). The index of each word it loads (the
    pivots, the octet's 8 docs and 8 tfs) goes to `reads`."""
    base = 0
    for span in (32, 8):
        idx = [base + i * span - 1 for i in (1, 2, 3)]
        if reads is not None:
            reads.extend(idx)
        base += span * sum(int(row[i] < doc) for i in idx)
    if reads is not None:
        reads.extend(range(base, base + 8))
        reads.extend(range(128 + base, 136 + base))
    for i in range(8):
        if row[base + i] == doc:
            return True, int(row[128 + base + i])
    return False, 0


@pytest.mark.parametrize("kind", list(CASES))
def test_region_search_emulation_matches_twin_probe(kind):
    """Every probe K4 makes (each live lane of each real item in each other
    clause's region), emulated in numpy as the kernel runs it, finds what
    the twin's fixed-depth binary search (`probe_term`) finds, at the
    reference's depth and at the ladder's deepest: the depth covers every
    region, so an exact lower bound gives the same answer."""
    rows, tables, cstore, blk_last, Q, n_iters = CASES[kind]()
    r, st, bl = rows.numpy(), cstore.numpy(), blk_last.numpy()
    cl_start, cl_len = tables[2].numpy(), tables[3].numpy()
    real = r[:, 1] < Q
    lanes, want_found, want_tf, starts, lens = [], [], [], [], []
    for bid, q, lcl in r[real]:
        docs = st[bid, :128]
        ok = (docs != TERMINATED) & ~np.isnan(st[bid, 256:].view(np.float32))
        for tc in range(cl_start.shape[1]):
            s, n = int(cl_start[q, tc]), int(cl_len[q, tc])
            if tc == lcl or n == 0:
                continue
            for d in docs[ok]:
                row = _lower_bound4(bl, s, n, d)
                assert row == s + np.searchsorted(bl[s:s + n], d)
                found, tf = (_probe_row(st[row], d) if row < s + n
                             else (False, 0))
                lanes.append(d)
                want_found.append(found)
                want_tf.append(tf)
                starts.append(s)
                lens.append(n)
    assert sum(want_found) > 20, "the case's probes find too little"
    args = [torch.from_numpy(np.array(a, np.int64))
            for a in (lanes, starts, lens)]
    for depth in (n_iters, ps._ITER_LADDER[-1]):
        found, tf = ps.probe_term(cstore, blk_last, args[0].int(), args[1],
                                  args[2], depth)
        assert np.array_equal(found.numpy(), np.array(want_found))
        hit = found.numpy()
        assert np.array_equal(tf.numpy()[hit], np.array(want_tf)[hit])


def _sectors(kind):
    """K4 on one chunk, probe by probe: (the distinct 32-byte sectors the
    work needs, whatever a kernel loads: each real item's own row, and for
    each live lane and other clause the docs sector of the region row that
    holds its doc or would, and on a hit its tf sector; the distinct
    sectors the kernel's first design loaded: the own rows, the `blk_last`
    keys of
    `lower_bound4` over the whole region and the row words `probe_row`
    reads), and the smoke's record and bytes of the launch rows, tables
    and [W, kk] outputs."""
    rows, tables, cstore, blk_last, Q, _ = CASES[kind]()
    r, st, bl = rows.numpy(), cstore.numpy(), blk_last.numpy()
    cl_start, cl_len = tables[2].numpy(), tables[3].numpy()
    nb = st.shape[0]
    need, row_sec, last_sec = set(), set(), set()
    for bid, q, lcl in r:
        if not (0 <= q < Q and 0 <= bid < nb):
            continue
        need.update(range(bid * 48, bid * 48 + 48))
        row_sec.update(range(bid * 48, bid * 48 + 48))
        docs = st[bid, :128]
        ok = (docs != TERMINATED) & ~np.isnan(st[bid, 256:].view(np.float32))
        for tc in range(cl_start.shape[1]):
            s = int(cl_start[q, tc])
            e = min(s + int(cl_len[q, tc]), nb)
            if tc == lcl or s < 0 or e <= s:
                continue
            for d in docs[ok]:
                keys, words = [], []
                row = _lower_bound4(bl, s, e - s, d, keys)
                last_sec.update(i // 8 for i in keys)
                if row < e:
                    _probe_row(st[row], d, words)
                    row_sec.update(row * 48 + w // 8 for w in words)
                    at = int(np.searchsorted(st[row, :128], d))
                    need.add(row * 48 + at // 8)
                    if st[row, at] == d:
                        need.add(row * 48 + 16 + at // 8)
    assert last_sec and len(row_sec) > 48
    small = (r.nbytes + sum(a.numel() * 4 for a in tables)
             + len(r) * 10 * 8)
    rec = dict(cstore=cstore, blk_last=blk_last, tables=tables,
               num_queries=Q, k=10)
    return need, row_sec | {("last", i) for i in last_sec}, rec, rows, small


@pytest.mark.parametrize("kind", list(CASES))
def test_smoke_byte_count_is_the_sectors_the_probes_load(kind):
    """The smoke's byte count for K4 (`chip_smoke.deep_probe_bytes`, all
    probes at once in torch) is the distinct 32-byte sectors the work
    needs, counted probe by probe here: each real item's own row (48
    sectors), and for each live lane and other clause the docs sector of
    the region row that holds its doc or would and, on a hit, its tf
    sector; plus the launch rows, the tables and the [W, kk] outputs. One
    bound for every build of K4."""
    need, _, rec, rows, small = _sectors(kind)
    assert chip_smoke.deep_probe_bytes(rec, rows) == 32 * len(need) + small


@pytest.mark.parametrize("kind", list(CASES))
def test_smoke_byte_count_is_at_most_what_the_first_design_loads(kind):
    """The work the bound counts is at most what K4's first design (a 4-ary
    search over each whole clause region, then `probe_row`) loaded, emulated
    probe by probe: its probes loaded every sector the work needs, and
    their search words besides."""
    need, first, rec, rows, small = _sectors(kind)
    assert need <= first
    assert chip_smoke.deep_probe_bytes(rec, rows) < 32 * len(first) + small


@pytest.mark.parametrize("kind", list(CASES))
def test_twin_rows_order_ties(kind):
    """The twin's item top-kk is (score desc, lane asc) over its reporting
    lanes, -inf / TERMINATED past them, and padding items report
    nothing."""
    rows, tables, cstore, blk_last, Q, n_iters = CASES[kind]()
    sc, dc = dp.deep_probe_ref(rows, *tables, cstore, blk_last,
                               num_queries=Q, kk=128, n_iters=n_iters)
    pad = rows[:, 1] >= Q
    assert torch.isinf(sc[pad]).all() and (dc[pad] == TERMINATED).all()
    assert (sc[:, :-1] >= sc[:, 1:]).all()
    dead = ~torch.isfinite(sc)
    assert (dc[dead] == TERMINATED).all()
    lane_docs = cstore[rows[:, 0].long(), :128]
    for i in torch.nonzero(~pad).flatten().tolist():
        n = int((~dead[i]).sum())
        if n < 2:
            continue
        pos = torch.searchsorted(lane_docs[i], dc[i, :n].contiguous())
        tied = sc[i, 1:n] == sc[i, :n - 1]
        assert (pos[1:][tied] > pos[:-1][tied]).all()


def test_launch_rows_match_reference_inputs(wide_index):
    """`dispatch_probe`'s deep chunks hold the reference deep probe's
    inputs: each launch row names a fused-store row whose docs and tfs are
    the block the reference gathers, with its query and own clause, and
    each clause region's rows and the search depth are the reference's.
    The reference pads its chunks (qid = num_queries); the port launches
    only the real items, so the chunks hold as many items as the
    reference's real ones."""
    queries = [
        tt.BooleanQuery.intersection([t("r"), t("a")]),
        tt.BooleanQuery.intersection([t("r"), t("h")]),
        tt.BooleanQuery([(tt.Occur.MUST, t("h")),
                         (tt.Occur.MUST_NOT, t("m"))]),
        tt.BooleanQuery([(tt.Occur.SHOULD, t(x)) for x in ("r", "m", "h")],
                        minimum_number_should_match=2),
    ]
    calls = []
    real_probe = ref_ps.probe_bool_topk

    def record(*args, **kw):
        calls.append((args, kw))
        return real_probe(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ps, "probe_bool_topk", record)
        jax_par.BatchExecutor(wide_index).search_boolean_batch(queries, 10)
    port = BatchExecutor(port_searcher(wide_index), device="cpu",
                         fused=False)
    port.launch_log = []
    port.search_boolean_batch(to_port(queries), 10)
    deep = [rec for rec in port.launch_log if rec["kind"] == "deep"]
    assert len(deep) == len(calls) == port.plan_stats["probe_deep"] > 0
    for rec, (args, kw) in zip(deep, calls):
        docs, tfs, q_pad, c_pad, valid, store_docs, store_tfs = (
            np.asarray(a) for a in args[:7])
        ref_tables = [np.asarray(a) for a in args[11:18]]
        rows = rec["rows"].numpy()
        st = rec["cstore"].numpy()
        assert rows.shape == (int(valid.sum()), dp.ROW_COLS)
        assert np.array_equal(st[rows[:, 0], :128].view(np.uint32),
                              docs[valid])
        assert np.array_equal(st[rows[:, 0], 128:256].view(np.uint32),
                              tfs[valid])
        assert np.array_equal(rows[:, 1], q_pad[valid])
        assert np.array_equal(rows[:, 2], c_pad[valid])
        assert rec["n_iters"] == kw["n_iters"]
        assert rec["num_queries"] == kw["num_queries"]
        tables = [x.numpy() for x in rec["tables"]]
        for i in (0, 1, 3, 5, 6):
            assert np.array_equal(tables[i], ref_tables[i])
        assert np.array_equal(tables[4] > 0, ref_tables[4])
        port_start, ref_start = tables[2], ref_tables[2]
        blk_last = rec["blk_last"].numpy()
        ref_last = np.asarray(args[7])
        for qi, ti in zip(*np.nonzero(tables[3] > 0)):
            n = int(tables[3][qi, ti])
            a, b = int(port_start[qi, ti]), int(ref_start[qi, ti])
            assert np.array_equal(st[a:a + n, :128].view(np.uint32),
                                  store_docs[b:b + n])
            assert np.array_equal(blk_last[a:a + n].view(np.uint32),
                                  ref_last[b:b + n])


def test_wrapper_takes_twin_on_cpu_and_checks_inputs():
    rows, tables, cstore, blk_last, Q, n_iters = _hard("ladder_edge")
    kw = dict(num_queries=Q, kk=10, n_iters=n_iters)
    n0 = dp.launches
    got = dp.deep_probe(rows, *tables, cstore, blk_last, **kw)
    want = dp.deep_probe_ref(rows, *tables, cstore, blk_last, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dp.launches == n0  # the twin does not count
    bad = [
        (rows.long(), tables, cstore, blk_last, kw),
        (torch.cat([rows, rows[:, :1]], 1), tables, cstore, blk_last, kw),
        (rows, tables, cstore[:, :256].contiguous(), blk_last, kw),
        (rows, tables, cstore, blk_last[:-1].contiguous(), kw),
        (rows, tables, cstore, blk_last, {**kw, "kk": 129}),
        (rows, tables, cstore, blk_last, {**kw, "num_queries": Q + 1}),
    ]
    for r, tb, st, bl, k in bad:
        with pytest.raises(ValueError):
            dp.deep_probe(r, *tb, st, bl, **k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kk", KKS)
@pytest.mark.parametrize("kind", list(CASES))
def test_kernel_matches_twin_on_card(cuda_device, kind, kk):
    rows, tables, cstore, blk_last, Q, n_iters = CASES[kind](
        device=cuda_device)
    kw = dict(num_queries=Q, kk=kk, n_iters=n_iters)
    n0 = dp.launches
    got = dp.deep_probe(rows, *tables, cstore, blk_last, **kw)
    want = dp.deep_probe_ref(rows, *tables, cstore, blk_last, **kw)
    torch.cuda.synchronize()
    assert dp.launches == n0 + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_probe_path_launches_the_kernel_on_card(cuda_device, wide_index):
    """`search_boolean_batch` on the card sends its deep chunks through K4
    (one launch per `probe_deep` chunk) and gives the CPU executor's
    hits."""
    queries = to_port([
        tt.BooleanQuery.intersection([t("r"), t("a")]),
        tt.BooleanQuery.union([t("a"), t("m")]),
        tt.BooleanQuery([(tt.Occur.SHOULD, t(x)) for x in ("r", "m", "h")],
                        minimum_number_should_match=2),
    ])
    searcher = port_searcher(wide_index)
    want = BatchExecutor(searcher, device="cpu",
                         fused=False).search_boolean_batch(queries, 10)
    ex = BatchExecutor(searcher, device="cuda", fused=False)
    n0 = dp.launches
    got = ex.search_boolean_batch(queries, 10)
    assert ex.plan_stats["probe_deep"] > 0
    assert dp.launches - n0 == ex.plan_stats["probe_deep"]
    assert got == want
