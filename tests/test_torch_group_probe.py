"""Kernel K1's plain twin (`group_probe_ref`) against the reference Pallas
kernel (`pallas_probe._grp_rows`, interpret mode) on launches captured from
a reference fused search, and the port's group collapse.

Both kernels get the same packed launch: the reference's [P, R, 128] SMEM
pages are unpacked to the [W, STRIDE] scalar rows the port's kernel takes.
Scores are compared as f32 bits, docs exactly. The CUDA kernel itself is
held against the same twin on the card (`cuda` marker)."""

import functools

import jax
import numpy as np
import pytest
import torch

import tantivy_tpu as tt
from tantivy_tpu.ops import pallas_probe as pp
from tantivy_tpu.parallel import BatchExecutor as JaxBatchExecutor
from tantivy_tpu_torch.ops import fused_bool as fb
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops.group_probe import group_probe, group_probe_ref

import zstd_stub
from tantivy_tpu.postings.format import TERMINATED
from test_fused_bool import build_zipf_index


def _t(w, field="body"):
    return tt.TermQuery(tt.Term.from_field_text(field, w))


def _queries(words):
    rng = np.random.default_rng(5)
    qs = [_t(words[i]) for i in range(0, 8)]
    qs += [tt.BooleanQuery.union([_t(words[i]), _t(words[i + 1])])
           for i in range(0, 8, 2)]
    qs += [tt.BooleanQuery.intersection([_t(words[i]), _t(words[i + 3])])
           for i in range(0, 6, 2)]
    for n in (3, 4, 6, 8, 12, 16):
        ws = rng.choice(words, n, replace=False)
        qs.append(tt.BooleanQuery.union([_t(w) for w in ws]))
    qs.append(tt.BooleanQuery([
        (tt.Occur.MUST, _t(words[0])), (tt.Occur.MUST_NOT, _t(words[1])),
    ]))
    qs.append(tt.BooleanQuery(
        [(tt.Occur.SHOULD, _t(words[i])) for i in (0, 1, 5)],
        minimum_number_should_match=2,
    ))
    qs.append(tt.BooleanQuery.union([_t(words[2]), _t(words[3], "title")]))
    return qs


def _rows_of(scal, W, G, T):
    """[P, R, 128] reference scalar pages -> [W, STRIDE] scalar rows."""
    stride = pp._grp_scal_layout(T, G)[0]
    assert stride == fb._grp_scal_layout(T)
    P = W // G
    pages = np.asarray(scal).reshape(P, -1)[:, :G * stride]
    return np.array(pages.reshape(W, stride))


def _port_topk(rung_scal, rung_qid, rung_seg, cl_weight, cl_kind, cl_start,
               cl_len, cl_shipped, req_must, req_should, row_th, cstore, *,
               k, num_queries, num_prows, n_clauses, rungs, interpret=False,
               pack_addr=False):
    """Stands in for the reference's jitted `fused_bool_topk` while
    launches are captured: the same launch through the port's twin and
    merge tail, returned as the reference's packed u32 result. The capture
    then costs no Pallas compile; every captured chunk is held against the
    real Pallas kernel in the tests below. `pack_addr` picks one of the
    reference's two merge-tail forms, which give the same result; the port
    has one."""
    chunks = [
        (torch.from_numpy(_rows_of(scal, W, G, n_clauses)),
         torch.from_numpy(np.array(qid)), torch.from_numpy(np.array(seg)))
        for (W, _, G), scal, qid, seg in zip(rungs, rung_scal, rung_qid,
                                             rung_seg)
    ]
    tables = tuple(
        torch.from_numpy(np.array(a)) for a in
        (cl_weight, cl_kind, np.asarray(cl_shipped).astype(np.int32),
         req_must, req_should, row_th)
    )
    packed = fb.fused_bool_topk(
        chunks, tables, torch.from_numpy(np.array(cstore).view(np.int32)),
        k, num_queries, num_prows,
    )
    return packed.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def launches():
    """Every fused launch of one reference search over the zipf corpus:
    the reference planner and launch assembly, capturing each launch's
    exact kernel inputs (`pallas_probe._DEBUG_LAUNCHES`)."""
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        index, words = build_zipf_index()
        searcher = index.reader().searcher()
        mp.setenv("TANTIVY_TPU_PALLAS", "1")
        # one phase-1 block per plan row, so phase 2 runs with thresholds
        mp.setenv("TANTIVY_TPU_M1", "1")
        mp.setattr(pp, "_DEBUG_LAUNCHES", [])
        mp.setattr(pp, "fused_bool_topk", _port_topk)
        JaxBatchExecutor(searcher).search_batch(_queries(words), 10)
        return list(pp._DEBUG_LAUNCHES)


def _cases(launches):
    """Named (launch, chunk) picks: every clause bucket, a phase-2 chunk
    with finite thresholds, a MUST_NOT and an m-of-n plan row."""
    cases = {}
    for rec in launches:
        t_args = [np.asarray(a) for a in rec["table_args"]]
        kind, req_should, row_th = t_args[1], t_args[6], t_args[7]
        tags = [f"T{rec['n_clauses']}"]
        if np.isfinite(row_th).any():
            tags.append(f"T{rec['n_clauses']}_phase2")
        if (kind == 2).any():
            tags.append("must_not")
        if (req_should[:rec["num_prows"]] >= 2).any():
            tags.append("m_of_n")
        for tag in tags:
            cases.setdefault(tag, rec)
    return cases


_grp_rows = jax.jit(
    functools.partial(pp._grp_rows, interpret=True),
    static_argnames=("n_clauses", "kw", "num_prows", "G", "W", "kk"),
)

CASES = ("T2", "T4", "T8", "T16", "T2_phase2", "must_not", "m_of_n")


def _twin_inputs(rec, device="cpu"):
    t_args = [np.asarray(a) for a in rec["table_args"]]
    cl_weight, cl_kind, _, _, cl_shipped, req_m, req_s, row_th = t_args
    tables = tuple(
        torch.from_numpy(np.array(a)).to(device)
        for a in (cl_weight, cl_kind, cl_shipped.astype(np.int32), req_m,
                  req_s, row_th)
    )
    cstore = torch.from_numpy(np.array(rec["cstore"]).view(np.int32)).to(device)
    return tables, cstore


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_pallas_kernel(launches, case):
    rec = _cases(launches).get(case)
    assert rec is not None, f"the search made no {case} launch"
    T, kk = rec["n_clauses"], min(rec["k"], 128)
    tables, cstore = _twin_inputs(rec)
    reported = 0
    for (W, kw, G), scal, _, _ in rec["chunks"]:
        want_sc, want_dc = _grp_rows(
            scal, *rec["table_args"], rec["cstore"], n_clauses=T, kw=kw,
            num_prows=rec["num_prows"], G=G, W=W, kk=kk,
        )
        want_sc = np.asarray(want_sc)[:, :kk]
        want_dc = np.asarray(want_dc)[:, :kk]
        rows = torch.from_numpy(_rows_of(scal, W, G, T))
        got_sc, got_dc = group_probe_ref(
            rows, *tables, cstore, num_prows=rec["num_prows"], kk=kk
        )
        assert np.array_equal(got_sc.numpy().view(np.int32),
                              want_sc.view(np.int32))
        assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
        reported += int(np.isfinite(want_sc).sum())
    assert reported > 0, "the compared chunks report no lane"


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(launches):
    rec = _cases(launches)["T2"]
    tables, cstore = _twin_inputs(rec)
    (W, _, G), scal, _, _ = rec["chunks"][0]
    rows = torch.from_numpy(_rows_of(scal, W, G, 2))
    kk = min(rec["k"], 128)
    got = group_probe(rows, *tables, cstore, num_prows=rec["num_prows"],
                      kk=kk)
    want = group_probe_ref(rows, *tables, cstore,
                           num_prows=rec["num_prows"], kk=kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        group_probe(rows.long(), *tables, cstore,
                    num_prows=rec["num_prows"], kk=kk)
    with pytest.raises(ValueError):
        group_probe(rows, *tables, cstore[:, :256].contiguous(),
                    num_prows=rec["num_prows"], kk=kk)
    with pytest.raises(ValueError):
        group_probe(rows, *tables, cstore, num_prows=rec["num_prows"],
                    kk=129)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin_on_card(launches, cuda_device, case):
    rec = _cases(launches)[case]
    tables, cstore = _twin_inputs(rec, cuda_device)
    kk = min(rec["k"], 128)
    for (W, _, G), scal, _, _ in rec["chunks"]:
        rows = torch.from_numpy(
            _rows_of(scal, W, G, rec["n_clauses"])
        ).to(cuda_device)
        got = group_probe(rows, *tables, cstore,
                          num_prows=rec["num_prows"], kk=kk)
        want = group_probe_ref(rows, *tables, cstore,
                               num_prows=rec["num_prows"], kk=kk)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# synthetic hard cases (`ops/kernel_cases.py`): the twin against the Pallas
# kernel on the CPU, the kernel against the twin on the card


def _synthetic_args(case, device="cpu"):
    rows = torch.from_numpy(case["rows"]).to(device)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in case["tables"])
    cstore = torch.from_numpy(case["cstore"].view(np.int32)).to(device)
    return rows, tables, cstore


def _pages_of(rows, T, G):
    """[W, STRIDE] scalar rows -> the reference's [P, R, 128] pages."""
    stride, _, R = pp._grp_scal_layout(T, G)
    W = rows.shape[0]
    flat = rows[:, :stride].reshape(W // G, G * stride)
    return np.pad(flat, ((0, 0), (0, R * 128 - G * stride))).reshape(
        W // G, R, 128)


def _windows(case):
    """Per live group and clause: the union [lo, hi) of its members'
    sub-windows, relative to jlo, and whether every member probes it."""
    T, A = case["T"], 4 + case["T"]
    out = []
    for row in case["rows"][:case["n_groups"]]:
        for t in range(T):
            pk = row[A + 8 * t:A + 8 * t + 8]
            ln, off = pk & 255, pk >> 8
            if row[4 + t] >= 0 and (ln > 0).any():
                out.append((int(off[ln > 0].min()), int((off + ln).max()),
                            bool((ln > 0).all())))
    return out


@pytest.mark.parametrize("kind", kc.GROUP_KINDS)
def test_synthetic_group_cases_reach_what_they_claim(kind):
    case = kc.group_case(kind)
    rows, cstore = case["rows"], case["cstore"]
    live = rows[:case["n_groups"]]
    assert (live[:, 3] == 0xFF).all() and (rows[case["n_groups"]:, 3] == 0).all()
    members = cstore[(live[:, :1] + np.arange(8)).reshape(-1)]
    wins = _windows(case)
    spans = [hi - lo for lo, hi, _ in wins]
    if kind == "ties":
        # every lane of every member is alive: 1,024 survivors a group
        assert (members[:, :128] != TERMINATED).all()
        assert not np.isnan(members[:, 256:].view(np.float32)).any()
    elif kind == "t16":
        assert case["T"] == 16 and len(wins) == 16 * case["n_groups"]
        assert all(every for _, _, every in wins)
        assert np.isfinite(case["tables"][5][0])
    elif kind == "wide":
        assert max(spans) > 16 and max(hi for _, hi, _ in wins) <= 64
    else:
        assert max(spans) > 256 and (live[:, 4 + 1] >= 0).all()
    sc, _ = group_probe_ref(*_flat(_synthetic_args(case)),
                            num_prows=case["num_prows"], kk=128)
    assert torch.isfinite(sc).sum() >= 20 * case["n_groups"]


def _flat(args):
    rows, tables, cstore = args
    return (rows, *tables, cstore)


#: (kind, kk) of the twin-vs-Pallas checks: the tie order at three cuts
SYNTH = [("ties", 1), ("ties", 10), ("ties", 128), ("t16", 10),
         ("wide", 10)]


@pytest.mark.parametrize("kind,kk", SYNTH)
def test_twin_matches_pallas_kernel_on_synthetic_chunks(kind, kk):
    case = kc.group_case(kind)
    T, kw = case["T"], case["kw"]
    G = pp._g_items_grp(kw, T)
    cl_weight, cl_kind, cl_shipped, req_m, req_s, row_th = case["tables"]
    want_sc, want_dc = _grp_rows(
        _pages_of(case["rows"], T, G), cl_weight, cl_kind, case["cl_start"],
        case["cl_len"], cl_shipped, req_m, req_s, row_th, case["cstore"],
        n_clauses=T, kw=kw, num_prows=case["num_prows"], G=G,
        W=case["rows"].shape[0], kk=kk,
    )
    want_sc = np.asarray(want_sc)[:, :kk]
    want_dc = np.asarray(want_dc)[:, :kk]
    got_sc, got_dc = group_probe_ref(*_flat(_synthetic_args(case)),
                                     num_prows=case["num_prows"], kk=kk)
    assert np.array_equal(got_sc.numpy().view(np.int32),
                          want_sc.view(np.int32))
    assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
    if kind == "ties":
        # the cut splits a run of equal scores in every live group
        full, _ = group_probe_ref(*_flat(_synthetic_args(case)),
                                  num_prows=case["num_prows"], kk=kk + 1)
        assert (full[:case["n_groups"], kk - 1]
                == full[:case["n_groups"], kk]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 10, 128])
@pytest.mark.parametrize("kind", kc.GROUP_KINDS)
def test_kernel_matches_twin_on_synthetic_chunks(cuda_device, kind, kk):
    case = kc.group_case(kind)
    args = _flat(_synthetic_args(case, cuda_device))
    got = group_probe(*args, num_prows=case["num_prows"], kk=kk)
    want = group_probe_ref(*args, num_prows=case["num_prows"], kk=kk)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# group collapse: native single pass vs numpy


def _canon(out):
    base, mask, prow, cl, qid, seg, jlo, pk, eff = out
    return sorted(
        (int(base[i]), int(mask[i]), int(prow[i]), int(cl[i]), int(qid[i]),
         int(seg[i]), tuple(int(x) for x in jlo[i]),
         tuple(int(x) for x in np.asarray(pk[i]).reshape(-1)), int(eff[i]))
        for i in range(len(base))
    )


def _one_run(n):
    """n groupable items of one (prow, clause) 8-block run, blocks
    0..7 repeated in order (so n > 8 means duplicate blocks). Windows are
    spaced 64 rows apart, so the union of any two busts kw_max=32."""
    T = 2
    blocks = np.sort(np.arange(n) % 8).astype(np.int64)
    jlo = ((np.arange(n) * 64)[:, None] * np.ones((1, T))).astype(np.int32)
    return (
        blocks, np.zeros(n, np.int32), np.zeros(n, np.int32),
        np.zeros(n, np.int32), np.zeros(n, np.int32), jlo,
        np.full((n, T), 16, np.int32), np.zeros((n, T), np.int32),
        np.ones(n, dtype=bool),
    )


@pytest.mark.parametrize("n", [9, 12, 8])
def test_group_collapse_native_and_numpy_agree(n):
    """Nine or more duplicate items in one wide run: the native pass keeps
    at most 8 members per run, so the port's `_group_work` must take the
    numpy path and emit one singleton per item, as numpy does."""
    work = _one_run(n)
    got = fb._group_work(*work, 32)
    want = fb._group_work_np(*work, 32)
    assert len(got[0]) == n
    assert _canon(got) == _canon(want)


def test_native_collapse_gap_and_unsorted_decline():
    """Pins the two facts `_group_work` relies on: the native pass drops
    members past 8 in a duplicate run, and declines unsorted keys."""
    from tantivy_tpu_torch.native_probe import _load, group_work_sorted

    if _load() is None:
        pytest.skip("native probe-plan library unavailable")
    work = _one_run(9)
    native = group_work_sorted(*work, 32)
    assert native is not None and len(native[0]) == 8
    blocks = np.array([16, 8, 0, 24], dtype=np.int64)
    work = _one_run(4)
    assert group_work_sorted(blocks, *work[1:], 32) is None
