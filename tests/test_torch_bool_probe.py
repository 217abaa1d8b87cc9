"""Kernel K3's plain twin (`bool_probe_lanes` / `bool_probe_ref`), its
top-k tail and kernel K4's twin (the deep per-lane probe,
`deep_probe.deep_probe_topk` on the CPU) against the reference: the Pallas
kernel `pallas_probe._probe_rows` and its wrapper `pallas_bool_topk` in
interpret mode, and the XLA `probe_scorer.probe_bool_topk`.

Every comparison feeds both sides the same packed inputs, made from a seed
with numpy: a store of sorted term regions built with the reference's
`build_cstore_np` (deleted docs give NaN denominators), per-query clause
tables with MUST, SHOULD, MUST_NOT and minimum_should_match, work items
with padding items (qid = num_queries), window starts from `compute_jlo`
with some set to -1 (no probe), and few distinct tfs and norms so that
equal scores straddle the row top-k cut. Scores are compared as f32 bits,
docs exactly. The CUDA kernel is held against the twin on the card
(`cuda` marker)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops import pallas_probe as pp
from tantivy_tpu.ops import probe_scorer as ref_ps
from tantivy_tpu.ops.fused_store import build_cstore_np
from tantivy_tpu.postings.format import TERMINATED
from tantivy_tpu_torch.ops import bool_probe as bp
from tantivy_tpu_torch.ops import deep_probe as dp
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops import probe_scorer as ps
from tantivy_tpu_torch.ops.fused_store import FusedStore, _check_region_order

import zstd_stub
from test_device_phrase import build_phrase_index
from test_fused_bool import build_zipf_index
from test_torch_host_parity import port_searcher

Q = 6
#: blocks per term region: rare terms against dense partners
REGION_BLOCKS = (1, 2, 5, 12, 40, 90)
MAX_DOC = 16_000


class _Dfp:
    """The block tables `compute_jlo` reads from a (segment, field)."""

    def __init__(self, docs):
        self.num_blocks = docs.shape[0]
        self.blk_base = docs[:, 0].copy()
        real = docs != np.uint32(TERMINATED)
        last = np.where(real, docs, 0).max(axis=1)
        self.blk_last_doc = np.where(real.any(axis=1), last,
                                     np.uint32(TERMINATED)).astype(np.uint32)


def _store(rng):
    """Term regions of sorted docs; returns (docs, tfs, norm_ids, alive,
    cache, region starts, region lengths)."""
    docs, tfs, starts = [], [], []
    for nb in REGION_BLOCKS:
        starts.append(sum(len(d) for d in docs))
        n = nb * 128 - int(rng.integers(0, 100))
        d = np.sort(rng.choice(MAX_DOC, n, replace=False)).astype(np.uint32)
        pad = np.full(nb * 128 - n, TERMINATED, dtype=np.uint32)
        docs.append(np.concatenate([d, pad]).reshape(nb, 128))
        # few distinct tfs: ties in every row
        tf = rng.integers(1, 3, nb * 128).astype(np.uint32)
        tfs.append(tf.reshape(nb, 128))
    docs, tfs = np.concatenate(docs), np.concatenate(tfs)
    norm_ids = rng.integers(0, 3, MAX_DOC).astype(np.uint8)
    alive = rng.random(MAX_DOC) > 0.05
    cache = (rng.random(256) * 2 + 0.5).astype(np.float32)
    return (docs, tfs, norm_ids, alive, cache, np.array(starts),
            np.array(REGION_BLOCKS))


def make_case(kw: int, T: int, seed: int = 0) -> dict:
    """One packed launch of W items for rung `kw` and clause bucket `T`."""
    rng = np.random.default_rng(seed * 100 + kw * 10 + T)
    docs, tfs, norm_ids, alive, cache, rstart, rlen = _store(rng)
    cstore = build_cstore_np(docs, tfs, norm_ids, alive, cache)
    dfp = _Dfp(docs)
    cl_weight = np.zeros((Q + 1, T), np.float32)
    cl_kind = np.full((Q + 1, T), ps.KIND_ABSENT, np.int32)
    cl_start = np.zeros((Q + 1, T), np.int32)
    cl_len = np.zeros((Q + 1, T), np.int32)
    cl_shipped = np.zeros((Q + 1, T), np.int32)
    req_must = np.zeros(Q + 1, np.int32)
    req_should = np.zeros(Q + 1, np.int32)
    req_must[Q] = 1 << 30
    items = []  # (bid, qid, lcl)
    for q in range(Q):
        n_cl = int(rng.integers(2, T + 1))
        terms = rng.choice(len(REGION_BLOCKS), n_cl, replace=False)
        kinds = rng.choice([ps.KIND_MUST, ps.KIND_SHOULD, ps.KIND_MUST_NOT],
                           n_cl, p=[0.35, 0.45, 0.2])
        if not (kinds != ps.KIND_MUST_NOT).any():
            kinds[0] = ps.KIND_SHOULD
        for c, (term, kd) in enumerate(zip(terms, kinds)):
            cl_kind[q, c] = kd
            cl_start[q, c] = rstart[term]
            cl_len[q, c] = rlen[term]
            cl_weight[q, c] = (0.0 if kd == ps.KIND_MUST_NOT
                               else np.float32(rng.integers(1, 4)))
        n_must = int((kinds == ps.KIND_MUST).sum())
        n_should = int((kinds == ps.KIND_SHOULD).sum())
        req_must[q] = n_must
        req_should[q] = (int(rng.integers(0, n_should + 1)) if n_should
                         else 0)
        if n_must == 0:
            req_should[q] = max(req_should[q], 1)
        positive = [c for c in range(n_cl) if kinds[c] != ps.KIND_MUST_NOT]
        musts = [c for c in positive if kinds[c] == ps.KIND_MUST]
        shipped = ([min(musts, key=lambda c: cl_len[q, c])] if musts
                   else positive)
        for c in shipped:
            cl_shipped[q, c] = 1
            n = int(cl_len[q, c])
            blocks = rng.choice(n, min(n, 6), replace=False)
            items += [(int(cl_start[q, c]) + int(b), q, c) for b in blocks]
    G = pp._g_items(kw, T)
    W = -(-(len(items) + 3) // G) * G  # at least 3 padding items
    bids = np.zeros(W, np.int32)
    qid = np.full(W, Q, np.int32)
    lcl = np.zeros(W, np.int32)
    for i, (b, q, c) in enumerate(items):
        bids[i], qid[i], lcl[i] = b, q, c
    jlo = bp.compute_jlo(dfp, bids.astype(np.int64), qid, cl_start, cl_len,
                         kw)
    jlo[rng.random(jlo.shape) < 0.1] = -1  # no probe
    wid = rng.integers(0, bp._kw8(kw) + 1, size=(W, T)).astype(np.int32)
    return dict(
        kw=kw, T=T, W=W, G=G, bids=bids, qid=qid, lcl=lcl, jlo=jlo, wid=wid,
        tables=(cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_must,
                req_should),
        cstore=cstore, dfp=dfp, docs=docs, tfs=tfs, norm_ids=norm_ids,
        alive=alive, cache=cache,
    )


def _rows(case) -> np.ndarray:
    T = case["T"]
    rows = np.zeros((case["W"], bp.bool_scal_stride(T)), np.int32)
    rows[:, 0], rows[:, 1], rows[:, 2] = case["bids"], case["qid"], case["lcl"]
    rows[:, 3:3 + T] = case["jlo"]
    rows[:, 3 + T:3 + 2 * T] = case["wid"]
    return rows


def _port_args(case, device="cpu"):
    rows = torch.from_numpy(_rows(case)).to(device)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in case["tables"])
    cstore = torch.from_numpy(case["cstore"].view(np.int32)).to(device)
    return rows, tables, cstore


def _ref_scal(case):
    """The reference wrapper's per-item slot pack ([P, R, 128] pages)."""
    T, G, W = case["T"], case["G"], case["W"]
    stride, _, R = pp._bool_scal_layout(T, G)
    rows = _rows(case)[:, :stride]
    flat = rows.reshape(W // G, G * stride)
    flat = np.pad(flat, ((0, 0), (0, R * 128 - G * stride)))
    return flat.reshape(W // G, R, 128)


_probe_rows = jax.jit(
    functools.partial(pp._probe_rows, interpret=True),
    static_argnames=("n_clauses", "kw", "num_prows", "G", "W"),
)

PARAMS = [(kw, T) for kw in (2, 8, 64) for T in (2, 4)]


@pytest.fixture(scope="module")
def cases():
    return {p: make_case(*p) for p in PARAMS}


@pytest.mark.parametrize("kw,T", PARAMS)
def test_twin_lanes_match_pallas_kernel(cases, kw, T):
    case = cases[(kw, T)]
    cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_m, req_s = \
        case["tables"]
    want_sc, want_dc = _probe_rows(
        jnp.asarray(_ref_scal(case)), cl_weight, cl_kind, cl_start, cl_len,
        cl_shipped, req_m, req_s, jnp.asarray(case["cstore"]),
        n_clauses=T, kw=kw, num_prows=Q, G=case["G"], W=case["W"],
    )
    want_sc, want_dc = np.asarray(want_sc), np.asarray(want_dc)
    rows, tables, cstore = _port_args(case)
    got_sc, got_dc = bp.bool_probe_lanes(rows, *tables, cstore, kw=kw,
                                         num_queries=Q)
    assert np.array_equal(got_sc.numpy().view(np.int32),
                          want_sc.view(np.int32))
    assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
    reported = np.isfinite(want_sc)
    assert reported.sum() > 50, "the case reports too few lanes"
    # the case holds what it claims: dead lanes, padding, skipped probes
    assert not reported[case["qid"] == Q].any()
    assert (case["jlo"] < 0).any()
    dead = np.isnan(case["cstore"][case["bids"], 256:].view(np.float32))
    assert (dead & (case["docs"][case["bids"]] != TERMINATED)).any()


def _tie_cut_k(sc: np.ndarray) -> int:
    """A k whose row cut splits a run of equal finite scores in some row."""
    for k in range(1, 20):
        s = -np.sort(-sc, axis=1)
        if (np.isfinite(s[:, k]) & (s[:, k - 1] == s[:, k])).any():
            return k
    raise AssertionError("no row has a tie to cut")


@pytest.mark.parametrize("kw,T", PARAMS)
def test_topk_matches_pallas_bool_topk(cases, kw, T):
    case = cases[(kw, T)]
    rows, tables, cstore = _port_args(case)
    lanes, _ = bp.bool_probe_lanes(rows, *tables, cstore, kw=kw,
                                   num_queries=Q)
    k = _tie_cut_k(lanes.numpy())
    want = pp.pallas_bool_topk(
        jnp.asarray(case["bids"]), jnp.asarray(case["qid"]),
        jnp.asarray(case["lcl"]), jnp.asarray(case["jlo"]),
        jnp.asarray(case["wid"]), *case["tables"],
        jnp.asarray(case["cstore"]), k=k, num_queries=Q, n_clauses=T,
        kw=kw, interpret=True,
    )
    got = bp.bool_probe_topk(rows, tables, cstore, k=k, num_queries=Q, kw=kw)
    assert tuple(got.shape) == (2, Q, k)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # the row top-kk of the twin is the kernel's selection order
    sc, dc = bp.bool_probe_ref(rows, *tables, cstore, kw=kw, num_queries=Q,
                               kk=k)
    assert torch.equal(sc, torch.sort(lanes, dim=1, descending=True,
                                      stable=True).values[:, :k])


@pytest.mark.parametrize("T", [2, 4])
def test_deep_probe_matches_reference(cases, T):
    """The port's deep per-lane probe (kernel K4's twin with the merge
    tail) equals the reference's XLA `probe_bool_topk` bit for bit; the
    port reads lanes, denominators and liveness from the cstore instead of
    gathered blocks and caches."""
    case = cases[(64, T)]
    k = 7
    cl_weight, cl_kind, cl_start, cl_len, cl_shipped, req_m, req_s = \
        case["tables"]
    docs = case["cstore"][:, :128]
    tfs = case["cstore"][:, 128:256]
    blk_last = _Dfp(docs).blk_last_doc
    n_iters = ps._iter_bucket(int(cl_len.max()))
    b, q, c = case["bids"], case["qid"], case["lcl"]
    want = ref_ps.probe_bool_topk(
        jnp.asarray(docs[b]), jnp.asarray(tfs[b]), jnp.asarray(q),
        jnp.asarray(c), jnp.asarray(q < Q), jnp.asarray(docs),
        jnp.asarray(tfs), jnp.asarray(blk_last), jnp.asarray(case["norm_ids"]),
        jnp.asarray(case["alive"]), jnp.asarray(case["cache"]), cl_weight,
        cl_kind, cl_start, cl_len, cl_shipped.astype(bool), req_m, req_s,
        k=k, num_queries=Q, n_clauses=T, n_iters=n_iters,
    )
    _, tables, cstore = _port_args(case)
    rows = torch.from_numpy(np.stack([b, q, c], axis=1).astype(np.int32))
    got = dp.deep_probe_topk(
        rows, tables, cstore, torch.from_numpy(blk_last.view(np.int32)),
        k=k, num_queries=Q, n_iters=n_iters,
    )
    want = np.asarray(want)
    assert np.isfinite(want[0].view(np.float32)).sum() > 10
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_merge_tail_matches_reference():
    """`per_query_topk_from_rows` on rows with ties, -inf and padding."""
    rng = np.random.default_rng(3)
    W, kk, nq, k = 40, 6, 5, 9
    sc = rng.integers(0, 4, (W, kk)).astype(np.float32)
    sc[rng.random((W, kk)) < 0.3] = -np.inf
    dc = rng.integers(0, 300, (W, kk)).astype(np.uint32)
    qid = rng.integers(0, nq + 1, W).astype(np.int32)
    want = ref_ps.pack_results(*ref_ps.per_query_topk_from_rows(
        jnp.asarray(sc), jnp.asarray(dc), jnp.asarray(qid), k, nq))
    got = ps.pack_results(*ps.per_query_topk_from_rows(
        torch.from_numpy(sc), torch.from_numpy(dc.view(np.int32)),
        torch.from_numpy(qid), k, nq))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    vals, docs = ps.unpack_results(got.numpy())
    assert vals.dtype == np.float32 and docs.dtype == np.uint32


def test_compute_jlo_matches_reference(cases):
    case = cases[(64, 4)]
    _, _, cl_start, cl_len, *_ = case["tables"]
    for kw in (2, 8, 64):
        args = (case["bids"].astype(np.int64), case["qid"], cl_start, cl_len,
                kw)
        assert np.array_equal(bp.compute_jlo(case["dfp"], *args),
                              pp.compute_jlo(case["dfp"], *args))


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(cases):
    case = cases[(8, 2)]
    rows, tables, cstore = _port_args(case)
    kw = dict(kw=8, num_queries=Q, kk=10)
    got = bp.bool_probe(rows, *tables, cstore, **kw)
    want = bp.bool_probe_ref(rows, *tables, cstore, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bp.launches == 0  # the twin does not count
    with pytest.raises(ValueError):
        bp.bool_probe(rows.long(), *tables, cstore, **kw)
    with pytest.raises(ValueError):
        bp.bool_probe(rows, *tables, cstore[:, :256].contiguous(), **kw)
    with pytest.raises(ValueError):
        bp.bool_probe(rows, *tables, cstore, kw=8, num_queries=Q, kk=129)
    with pytest.raises(ValueError):
        bp.bool_probe(rows[:, :4].contiguous(), *tables, cstore, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw,T", PARAMS)
def test_kernel_matches_twin_on_card(cases, cuda_device, kw, T):
    rows, tables, cstore = _port_args(cases[(kw, T)], cuda_device)
    for kk in (1, 10, 128):
        args = dict(kw=kw, num_queries=Q, kk=kk)
        got = bp.bool_probe(rows, *tables, cstore, **args)
        want = bp.bool_probe_ref(rows, *tables, cstore, **args)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# synthetic hard cases (`ops/kernel_cases.py`): the twin against the Pallas
# kernel on the CPU, the kernel against the twin on the card

HARD = [("every_row", 64), ("store_end", 8), ("store_end", 64)]


def _hard_args(case, device="cpu"):
    rows = torch.from_numpy(case["rows"]).to(device)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in case["tables"])
    cstore = torch.from_numpy(case["cstore"].view(np.int32)).to(device)
    return rows, tables, cstore


@pytest.mark.parametrize("kind,kw", HARD)
def test_twin_lanes_match_pallas_kernel_on_hard_cases(kind, kw):
    case = kc.bool_case(kind, kw)
    T, W, Qn = case["T"], case["rows"].shape[0], case["num_queries"]
    G = pp._g_items(kw, T)
    stride, _, R = pp._bool_scal_layout(T, G)
    scal = np.pad(case["rows"][:, :stride].reshape(W // G, G * stride),
                  ((0, 0), (0, R * 128 - G * stride))).reshape(W // G, R, 128)
    want_sc, want_dc = _probe_rows(
        jnp.asarray(scal), *case["tables"], jnp.asarray(case["cstore"]),
        n_clauses=T, kw=kw, num_prows=Qn, G=G, W=W,
    )
    rows, tables, cstore = _hard_args(case)
    got_sc, got_dc = bp.bool_probe_lanes(rows, *tables, cstore, kw=kw,
                                         num_queries=Qn)
    assert np.array_equal(got_sc.numpy().view(np.int32),
                          np.asarray(want_sc).view(np.int32))
    assert np.array_equal(got_dc.numpy().view(np.uint32), np.asarray(want_dc))
    # the case holds what it claims: the window's rows, the region's last
    # (padded) one among them, each hold a doc of every item; dead lanes
    st = case["cstore"]
    docs = st[:, :128]
    start, n = case["tables"][2][0, 1], case["tables"][3][0, 1]
    j = case["rows"][0, 4]
    win = np.arange(max(j, start), min(j + bp._kw8(kw), start + n))
    assert win[-1] == start + n - 1 and (docs[win[-1]] == TERMINATED).any()
    if kind == "store_end":
        assert win[-1] == st.shape[0] - 1
    for q in range(Qn):
        own = docs[case["rows"][q, 0]]
        assert all(np.isin(docs[r], own).any() for r in win)
    assert np.isnan(st[case["rows"][:Qn, 0], 256:].view(np.float32)).any()
    reported = np.isfinite(np.asarray(want_sc))
    assert reported.sum() > 10 * Qn and not reported[Qn:].any()


@pytest.mark.parametrize("kk", [1, 10, 128])
@pytest.mark.parametrize("kind,kw", HARD)
def test_row_topk_orders_ties_on_hard_cases(kind, kw, kk):
    """The twin's row top-kk is (score desc, lane asc), the order
    `lax.top_k` gives the Pallas kernel's raw rows, at cuts through runs of
    equal scores."""
    case = kc.bool_case(kind, kw)
    rows, tables, cstore = _hard_args(case)
    Qn = case["num_queries"]
    lanes, docs = bp.bool_probe_lanes(rows, *tables, cstore, kw=kw,
                                      num_queries=Qn)
    sc, dc = bp.bool_probe_ref(rows, *tables, cstore, kw=kw,
                               num_queries=Qn, kk=kk)
    order = torch.sort(lanes, dim=1, descending=True, stable=True)
    want_sc = order.values[:, :kk]
    want_dc = torch.where(torch.isfinite(want_sc),
                          docs.gather(1, order.indices[:, :kk]), TERMINATED)
    assert torch.equal(sc.view(torch.int32), want_sc.view(torch.int32))
    assert torch.equal(dc, want_dc)
    if kk < 128:
        s = order.values[:Qn]
        assert (s[:, kk - 1] == s[:, kk]).any(), "no cut splits a tie"


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 10, 128])
@pytest.mark.parametrize("kind,kw", HARD)
def test_kernel_matches_twin_on_hard_cases(cuda_device, kind, kw, kk):
    case = kc.bool_case(kind, kw)
    rows, tables, cstore = _hard_args(case, cuda_device)
    args = dict(kw=kw, num_queries=case["num_queries"], kk=kk)
    got = bp.bool_probe(rows, *tables, cstore, **args)
    want = bp.bool_probe_ref(rows, *tables, cstore, **args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the store's order check: the kernels' fence searches need docs to ascend
# strictly across the rows of each term region


class _Blocks:
    """The block tables `FusedStore.ensure_slab` checks first."""

    def __init__(self, base, last, starts, lens):
        self.blk_base = np.array(base, np.uint32)
        self.blk_last_doc = np.array(last, np.uint32)
        self.term_block_start = np.array(starts, np.int64)
        self.term_num_blocks = np.array(lens, np.int64)


@pytest.mark.parametrize("case,ok", [
    # two regions of two blocks; the second restarts the doc order
    (([0, 200, 5, 90], [150, 300, 80, 120], [0, 2], [2, 2]), True),
    # a doc repeated across two rows of one region
    (([0, 150, 5, 90], [150, 300, 80, 120], [0, 2], [2, 2]), False),
    # rows out of order inside a region
    (([0, 200, 5, 90], [150, 300, 80, 120], [0, 3], [3, 1]), False),
    # an empty row inside a region
    (([0, TERMINATED, 5], [150, TERMINATED, 80], [0, 2], [2, 1]), False),
])
def test_store_order_check(case, ok):
    if ok:
        _check_region_order(*case)
        return
    with pytest.raises(AssertionError, match="ascend strictly"):
        _check_region_order(*case)
    # the store checks a slab before it builds it
    with pytest.raises(AssertionError, match="ascend strictly"):
        FusedStore().ensure_slab(0, "body", _Blocks(*case), None, 1.0)


@pytest.mark.parametrize("fixture", ["zipf", "phrase"])
def test_fixture_stores_pass_the_order_check(fixture):
    """Every (segment, field) slab of the fixture indexes builds."""
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        if fixture == "zipf":
            (index, _), fields = build_zipf_index(), ("body", "title")
        else:
            index, fields = build_phrase_index()[0], ("body",)
        searcher = port_searcher(index)
        store = FusedStore("cpu")
        n = 0
        for seg_ord, reader in enumerate(searcher.segment_readers()):
            dseg = reader.device()
            for field in fields:
                store.ensure_slab(seg_ord, field, dseg.field_postings(field),
                                  dseg.alive_np, 1.0)
                n += 1
        assert n >= 2
