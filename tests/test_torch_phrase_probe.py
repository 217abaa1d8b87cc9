"""Kernel K2's plain twin (`phrase_probe_ref`) against the reference Pallas
kernel (`pallas_phrase._phrase_rows`, interpret mode) on launches captured
from a reference fused phrase search, and the wrapper's input checks.

Both kernels get the same launch: the reference's [P, R, 128] SMEM pages
are unfolded to the [W, STRIDE] scalar rows the port's kernel takes. Scores
are compared as f32 bits, docs exactly. The CUDA kernel itself is held
against the same twin on the card (`cuda` marker)."""

import functools

import jax
import numpy as np
import pytest
import torch

import tantivy_tpu as tt
from tantivy_tpu.ops import pallas_phrase as php
from tantivy_tpu.parallel import BatchExecutor as JaxBatchExecutor
from tantivy_tpu.query.phrase_query import PhrasePrefixQuery
from tantivy_tpu_torch.ops import fused_phrase as fp
from tantivy_tpu_torch.ops.phrase_probe import phrase_probe, phrase_probe_ref
from tantivy_tpu_torch.postings.format import TERMINATED

import zstd_stub
from test_device_phrase import build_phrase_index, sample_phrases
from test_torch_host_parity import port_searcher, to_port


def _rows_of(scal, W, G, S):
    """[P, R, 128] reference scalar pages -> [W, STRIDE] scalar rows."""
    stride = php._phrase_scal_layout(S, G)[0]
    assert stride == fp._phrase_scal_layout(S)
    pages = np.asarray(scal).reshape(W // G, -1)[:, :G * stride]
    return np.array(pages.reshape(W, stride))


def _i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _recorder(log):
    """Stands in for the reference's jitted `fused_phrase_topk` while
    launches are captured: records the launch, then runs it through the
    port's twin and merge tail and returns the reference's packed u32
    result. The capture then costs no Pallas compile; every captured chunk
    is held against the real Pallas kernel in the tests below."""

    def fused_phrase_topk(rung_scal, rung_qid, rung_seg, qw, row_th, cstore,
                          postore, *, k, num_queries, num_prows, n_partners,
                          rungs, interpret=False, pack_addr=False):
        rec = dict(
            chunks=[(shape, np.asarray(sc)) for shape, sc in
                    zip(rungs, rung_scal)],
            qw=np.array(qw), row_th=np.array(row_th),
            cstore=np.asarray(cstore), postore=np.asarray(postore), k=k,
            num_prows=num_prows, n_partners=n_partners,
        )
        log.append(rec)
        chunks = [
            (RR, torch.from_numpy(_rows_of(sc, W, G, n_partners)),
             torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
            for ((W, RR, G), sc), q, s in zip(rec["chunks"], rung_qid,
                                              rung_seg)
        ]
        packed = fp.fused_phrase_topk(
            chunks, torch.from_numpy(rec["qw"]),
            torch.from_numpy(rec["row_th"]), _i32(rec["cstore"]),
            _i32(rec["postore"]), k, num_queries, num_prows, n_partners,
        )
        return packed.numpy().view(np.uint32)

    return fused_phrase_topk


def _queries(texts):
    rng = np.random.default_rng(3)
    qs = [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 6, 2)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 4, 3)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 2, 4)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 2, 8)]
    # a phrase-prefix has one plan row per (segment, expansion) but a phase-1
    # budget per query, so its other rows run in phase 2 with thresholds
    qs += [PhrasePrefixQuery("body", p[:-1] + ["w"])
           for p in sample_phrases(rng, texts, 3, 2)]
    qs += [PhrasePrefixQuery("body", p[:-1] + ["w"])
           for p in sample_phrases(rng, texts, 3, 3)]
    return qs


@pytest.fixture(scope="module")
def launches():
    """Every fused phrase launch of reference searches over the phrase
    corpus: the reference planner and launch assembly, each launch's exact
    kernel inputs recorded."""
    log = []
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        index, _, texts = build_phrase_index()
        searcher = index.reader().searcher()
        mp.setenv("TANTIVY_TPU_PALLAS", "1")
        # one phase-1 block per plan row, so phase 2 runs with thresholds
        mp.setenv("TANTIVY_TPU_M1", "1")
        mp.setattr(php, "fused_phrase_topk", _recorder(log))
        for k in (10, 1):
            JaxBatchExecutor(searcher).search_batch(_queries(texts), k)
    return log


def _cases(launches):
    """Named launch picks: every partner bucket in phase 1 and buckets 1
    and 3 in phase 2 (finite row thresholds)."""
    cases = {}
    for rec in launches:
        tag = f"S{rec['n_partners']}"
        if np.isfinite(rec["row_th"]).any():
            tag += "_phase2"
        cases.setdefault(tag, rec)
    return cases


_phrase_rows = jax.jit(
    functools.partial(php._phrase_rows, interpret=True),
    static_argnames=("n_partners", "rows", "num_prows", "G", "W", "kk"),
)

CASES = ("S1", "S3", "S7", "S1_phase2", "S3_phase2")


def _twin_args(rec, device="cpu"):
    return (
        torch.from_numpy(rec["qw"]).to(device),
        torch.from_numpy(rec["row_th"]).to(device),
        _i32(rec["cstore"]).to(device),
        _i32(rec["postore"]).to(device),
    )


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_pallas_kernel(launches, case):
    rec = _cases(launches).get(case)
    assert rec is not None, f"the search made no {case} launch"
    S, kk = rec["n_partners"], min(rec["k"], 128)
    args = _twin_args(rec)
    reported = 0
    for (W, RR, G), scal in rec["chunks"]:
        want_sc, want_dc = _phrase_rows(
            scal, rec["qw"], rec["row_th"], rec["cstore"], rec["postore"],
            n_partners=S, rows=RR, num_prows=rec["num_prows"], G=G, W=W,
            kk=kk,
        )
        want_sc = np.asarray(want_sc)[:, :kk]
        want_dc = np.asarray(want_dc)[:, :kk]
        rows = torch.from_numpy(_rows_of(scal, W, G, S))
        got_sc, got_dc = phrase_probe_ref(
            rows, *args, n_partners=S, slab_rows=RR,
            num_prows=rec["num_prows"], kk=kk,
        )
        assert np.array_equal(got_sc.numpy().view(np.int32),
                              want_sc.view(np.int32))
        assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
        reported += int(np.isfinite(want_sc).sum())
    assert reported > 0, "the compared chunks report no lane"


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(launches):
    rec = _cases(launches)["S1"]
    qw, row_th, cstore, postore = _twin_args(rec)
    (W, RR, G), scal = rec["chunks"][0]
    rows = torch.from_numpy(_rows_of(scal, W, G, 1))
    kw = dict(n_partners=1, slab_rows=RR, num_prows=rec["num_prows"],
              kk=min(rec["k"], 128))
    got = phrase_probe(rows, qw, row_th, cstore, postore, **kw)
    want = phrase_probe_ref(rows, qw, row_th, cstore, postore, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        phrase_probe(rows.long(), qw, row_th, cstore, postore, **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore,
                     postore[:, :128].contiguous(), **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th[:-1].contiguous(), cstore, postore,
                     **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore, postore,
                     **dict(kw, n_partners=8))
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore, postore, **dict(kw, kk=129))


def test_twin_does_not_rely_on_position_order():
    """The twin's partner test is a set membership: reversing the positions
    inside every block's range of the port's store (which keeps every
    sub-range's set of positions but breaks the (owner, position) order the
    kernel's binary searches need) changes no output of the twin."""
    from tantivy_tpu_torch import BatchExecutor

    index, _, texts = build_phrase_index()
    port = BatchExecutor(port_searcher(index), device="cpu")
    port.launch_log = []
    port.search_batch(to_port(_queries(texts)), 10)
    fused = port._fused()
    bp = torch.from_numpy(fused.blk_pos.astype(np.int64))
    idx = torch.arange(int(bp[-1]))
    b = torch.searchsorted(bp, idx, right=True) - 1
    src = bp[b] + bp[b + 1] - 1 - idx
    rev = fused.postore.clone()
    for half in (slice(0, 128), slice(128, 256)):
        col = rev[:, half].reshape(-1)
        col[idx] = fused.postore[:, half].reshape(-1)[src]
        rev[:, half] = col.reshape(-1, 128)
    key = (rev[:, 128:].reshape(-1)[idx].long() << 32) | (
        rev[:, :128].reshape(-1)[idx].long()
    )
    assert bool((key[1:] < key[:-1]).any()), "the reversal kept the order"
    compared = 0
    for rec in port.launch_log:
        if rec["kind"] != "phrase":
            continue
        for rr, rows, _, _ in rec["chunks"]:
            kw = dict(n_partners=rec["n_partners"], slab_rows=rr,
                      num_prows=rec["num_prows"], kk=min(rec["k"], 128))
            want = phrase_probe_ref(rows, rec["qw"], rec["row_th"],
                                    rec["cstore"], rec["postore"], **kw)
            got = phrase_probe_ref(rows, rec["qw"], rec["row_th"],
                                   rec["cstore"], rev, **kw)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            compared += int(torch.isfinite(want[0]).sum())
    assert compared > 0


# ---------------------------------------------------------------------------
# synthetic chunks: the shapes the real launches above seldom reach


#: positions one buffer of the CUDA kernel holds per partner sub-range, for
#: S partners (`range_cap` in csrc/phrase_probe.cu); a longer partner
#: sub-range is staged as a sample of its keys
def kernel_range_cap(S):
    return ((12 * 1024 // 8 - 256) // (2 * S)) & ~3


#: kind -> (partners S, slab rows, groups, member mask, anchor positions
#: per member, partner positions per member, the last group at the store's
#: end, phase-2 thresholds)
SYNTH = {
    "dense_136_rows": (1, 136, 8, 0b01001001, 1900, 4600, False, False),
    "s7": (7, 24, 16, 0b10110101, 150, 110, False, False),
    "store_end": (3, 24, 16, 0b11111111, 70, 90, True, False),
    "all_members": (1, 24, 32, 0b11111111, 160, 200, False, False),
    "phase2": (2, 136, 8, 0b11111111, 1000, 1100, False, True),
    "slot_edges": (1, 136, 16, 0b11111111, 160, 900, False, False),
}


def synthetic_case(kind, seed=0):
    """One synthetic launch chunk of `kind` (see SYNTH): every group has its
    own anchor term, 8 member rows of 128 ascending lane docs (some lanes
    TERMINATED or deleted), and per member an anchor sub-range and a
    sub-range per partner, (owner, position)-sorted, with extra positions of
    docs that are no lane doc and partner positions that complete the
    phrase for about half of the anchor positions. Some members have an
    empty partner sub-range and some sub-ranges run past their slab window.
    Returns the kernel's inputs as numpy arrays and its keyword arguments."""
    S, RR, n_groups, mask, n_anchor, n_partner, at_end, phase2 = SYNTH[kind]
    rng = np.random.default_rng(seed)
    deltas = rng.choice([-3, -2, -1, 1, 2, 3, 4], S)
    flat_pos, flat_own = [], []

    def put(owners, positions):
        start = sum(len(p) for p in flat_pos)
        gap = int(rng.integers(0, 300))
        flat_pos.append(np.concatenate(
            [rng.integers(0, 50, gap), positions]).astype(np.int64))
        flat_own.append(np.concatenate(
            [np.full(gap, 7), owners]).astype(np.int64))
        return start + gap

    cstore_rows, groups = [], []
    doc0 = 0
    for g in range(n_groups):
        members = []
        for r in range(8):
            docs = doc0 + np.cumsum(rng.integers(1, 4, 128))
            doc0 = int(docs[-1]) + 1
            cachev = rng.uniform(0.4, 3.0, 128).astype(np.float32)
            cachev[rng.random(128) < 0.05] = np.nan
            if g == n_groups - 1 and r == 7:
                docs[100:] = TERMINATED
            # anchor positions: lane docs and, now and then, docs between
            # lanes (no lane's doc)
            own = rng.choice(docs[docs != TERMINATED] + rng.integers(0, 2),
                             n_anchor)
            pos = rng.integers(0, 400, n_anchor)
            key = np.unique(own * 100000 + pos)
            a_own, a_pos = key // 100000, key % 100000
            parts = []
            for s in range(S):
                hit = rng.random(len(a_own)) < 0.6
                p_own = np.concatenate([a_own[hit], rng.choice(
                    a_own, max(n_partner - int(hit.sum()), 1))])
                p_pos = np.concatenate([a_pos[hit] + deltas[s], rng.integers(
                    0, 400, len(p_own) - int(hit.sum()))])
                k = np.unique(p_own * 100000 + p_pos)
                parts.append((k // 100000, k % 100000))
            members.append((docs, cachev, (a_own, a_pos), parts))
            cstore_rows.append(np.concatenate([
                docs, rng.integers(1, 9, 128),
                cachev.view(np.int32)]).astype(np.int64))
        groups.append(members)
    last_group = n_groups - 1
    # regions: per group its anchor region, then each partner's; the last
    # group is laid out last, so with `at_end` its ranges end the store
    starts = []
    for g, members in enumerate(groups):
        a_at = [put(*m[2]) for m in members]
        p_at = [[put(*m[3][s]) for m in members] for s in range(S)]
        starts.append((a_at, p_at))
    total = sum(len(p) for p in flat_pos)
    npr = -(-total // 128)
    if not at_end:
        npr += 40
    pos = np.full(npr * 128, -1, np.int64)
    own = np.full(npr * 128, -1, np.int64)
    pos[:total] = np.concatenate(flat_pos)
    own[:total] = np.concatenate(flat_own)
    postore = np.concatenate(
        [pos.reshape(npr, 128), own.reshape(npr, 128)], axis=1
    ).astype(np.uint32).view(np.int32)

    A = 4 + 2 * S
    stride = fp._phrase_scal_layout(S)
    rows = np.zeros((n_groups, stride), np.int64)
    for g, members in enumerate(groups):
        a_at, p_at = starts[g]
        rows[g, 0] = 8 * g
        rows[g, 1] = g
        rows[g, 2] = mask
        sel = [r for r in range(8) if (mask >> r) & 1]
        arow0 = min((min(a_at[r] for r in sel) // 128) & ~7, npr - RR)
        rows[g, 3] = arow0
        for r in sel:
            llen = len(members[r][2][0])
            if g == last_group and r == sel[-1] and not at_end:
                llen += 5000  # runs past the slab window: cut
            rows[g, A + r] = a_at[r] - arow0 * 128
            rows[g, A + 8 + r] = llen
        for s in range(S):
            crow0 = min((min(p_at[s][r] for r in sel) // 128) & ~7, npr - RR)
            rows[g, 4 + 2 * s] = crow0
            rows[g, 5 + 2 * s] = deltas[s]
            for r in sel:
                plen = len(members[r][3][s][0])
                if (g + r + s) % 5 == 4 and g != last_group:
                    plen = 0  # an empty partner is satisfied
                rows[g, A + 16 + 16 * s + r] = p_at[s][r] - crow0 * 128
                rows[g, A + 24 + 16 * s + r] = plen
    if kind == "slot_edges":
        # partner sub-ranges of every length from 4 below to 3 above the
        # kernel's slot, at every alignment, inside each member's own
        # (sorted) partner positions
        cap = kernel_range_cap(S)
        for g in range(n_groups):
            for r in range(8):
                assert len(groups[g][r][3][0][0]) >= cap + 3 + g % 4
                rows[g, A + 16 + r] += g % 4
                rows[g, A + 24 + r] = cap - 4 + r
    cstore = np.concatenate(
        [np.stack(cstore_rows), np.full((8, 384), TERMINATED)]
    ).astype(np.int32)
    qw = rng.uniform(0.5, 4.0, n_groups + 1).astype(np.float32)
    row_th = np.full(n_groups + 1, -np.inf, np.float32)
    args = (rows.astype(np.int32), qw, row_th, cstore, postore)
    kw = dict(n_partners=S, slab_rows=RR, num_prows=n_groups,
              kk=8 if phase2 else 32)
    if phase2:
        sc, _ = phrase_probe_ref(*(torch.from_numpy(a) for a in args), **kw)
        fin = sc.numpy()[np.isfinite(sc.numpy())]
        row_th[:] = np.float32(np.median(fin))
    return args, kw


def _pallas_synthetic(args, kw):
    """The reference Pallas kernel (interpret mode) on a synthetic chunk:
    the scalar rows folded into its [P, R, 128] pages, G groups a page."""
    rows, qw, row_th, cstore, postore = args
    S, RR = kw["n_partners"], kw["slab_rows"]
    G = php._g_items_phrase(RR, S)
    stride, R = php._phrase_scal_layout(S, G)
    W = -(-rows.shape[0] // G) * G
    full = np.zeros((W, stride), np.int32)
    full[:, 1] = kw["num_prows"]
    full[:rows.shape[0]] = rows
    pages = np.zeros((W // G, R * 128), np.int32)
    pages[:, :G * stride] = full.reshape(W // G, G * stride)
    u32 = [np.ascontiguousarray(a).view(np.uint32) for a in
           (cstore, postore)]
    sc, dc = _phrase_rows(
        pages.reshape(W // G, R, 128), qw, row_th, *u32, n_partners=S,
        rows=RR,
        num_prows=kw["num_prows"], G=G, W=W, kk=kw["kk"],
    )
    n = rows.shape[0]
    return (np.asarray(sc)[:n, :kw["kk"]],
            np.asarray(dc)[:n, :kw["kk"]])


@pytest.mark.parametrize("kind", list(SYNTH))
def test_twin_matches_pallas_kernel_on_synthetic_chunks(kind):
    """The synthetic chunks reach what they are named for, and the twin
    equals the reference Pallas kernel on them, bit for bit."""
    args, kw = synthetic_case(kind)
    rows, S = args[0], kw["n_partners"]
    A = 4 + 2 * S
    live = rows[:, 2] != 0
    assert (rows[live, A + 8:A + 16] > 0).sum(axis=1).max() == (
        bin(SYNTH[kind][3]).count("1"))
    # the 136-row chunks' and the S = 7 chunk's members mostly stage their
    # partners as samples, the 136-row S = 1 chunk's at a stride of several
    # keys; the other chunks' members mostly fit one buffer whole; the
    # slot-edge chunk's partner sub-ranges straddle the slot's size
    cap = kernel_range_cap(S)
    longest = np.stack([rows[live, A + 24 + 16 * s:A + 32 + 16 * s]
                        for s in range(S)]).max(axis=0).max(axis=1)
    sampled = (longest > cap).mean()
    if kind in ("dense_136_rows", "s7", "phase2"):
        assert sampled > 0.5
    elif kind == "slot_edges":
        assert set(np.unique(rows[live, A + 24:A + 32] - cap)) == set(
            range(-4, 4))
    else:
        assert sampled < 0.5
    if kind == "dense_136_rows":
        assert rows[:, A + 24:A + 32].max() > 4 * cap
    if kind == "store_end":
        # the last group's last partner sub-ranges reach the store's last row
        npr, s = args[4].shape[0], S - 1
        crow0 = rows[-1, 4 + 2 * s]
        ends = (crow0 * 128 + rows[-1, A + 16 + 16 * s:A + 24 + 16 * s]
                + rows[-1, A + 24 + 16 * s:A + 32 + 16 * s])
        assert crow0 == npr - kw["slab_rows"]
        assert ends.max() > (npr - 1) * 128
    got_sc, got_dc = phrase_probe_ref(*(torch.from_numpy(a) for a in args),
                                      **kw)
    want_sc, want_dc = _pallas_synthetic(args, kw)
    assert np.array_equal(got_sc.numpy().view(np.int32),
                          want_sc.view(np.int32))
    assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
    assert np.isfinite(want_sc).sum() > 0, "the chunk reports no lane"
    if kind == "phase2":
        assert np.isfinite(args[2][:-1]).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin_on_card(launches, cuda_device, case):
    rec = _cases(launches)[case]
    args = _twin_args(rec, cuda_device)
    S = rec["n_partners"]
    for (W, RR, G), scal in rec["chunks"]:
        rows = torch.from_numpy(_rows_of(scal, W, G, S)).to(cuda_device)
        kw = dict(n_partners=S, slab_rows=RR, num_prows=rec["num_prows"],
                  kk=min(rec["k"], 128))
        got = phrase_probe(rows, *args, **kw)
        want = phrase_probe_ref(rows, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(SYNTH))
def test_kernel_matches_twin_on_synthetic_chunks(cuda_device, kind):
    """136-row slabs whose partner sub-ranges pass a shared-memory slot many
    times over, S = 7, ranges that end at the store's last row, groups with
    all 8 members live, a phase-2 threshold, and partner sub-ranges
    straddling the slot's size: kernel against twin, bit for bit."""
    args, kw = synthetic_case(kind)
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
    got = phrase_probe(*dev_args, **kw)
    want = phrase_probe_ref(*dev_args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool(torch.isfinite(want[0]).any())
