"""The fused boolean planner's UB sweep (`ops/ub_sweep.py`, kernel
`csrc/ub_sweep.cu`) against the numpy planner, bit for bit.

The kernel's twin is the port's numpy `batched_clause_details`, which the
wrapper returns for a store off the card. On the CPU its per-call dicts must
equal the per-call `FusedStore.clause_blocks_ub` and the reference's
`tantivy_tpu.parallel.wand.batched_clause_details`: ids, UB and term bits,
the window columns jlo, i0, i1 and widths, the same MUST drops. Stores are
built from seeded synthetic slabs (dense terms of hundreds of blocks, terms
of one block, rare terms whose one block spans a dense term's region, so
windows run wider than `fused_kw_max`), and the calls are drawn with 1 to
16 clauses, MUST drops, MUST_NOT others (weight 0.0), absent clauses (gaps
in the positions) and calls with no others. Calls of an empty other region
are held to `clause_blocks_ub` alone: the planner never makes them, and the
numpy batch's global key search does not handle them.

The `cuda` cases run the kernel on the same cases against the twin and the
per-call version, at a size whose grid spans several waves of the card, and
an executor-level batch on the card against the same batch with the numpy
sweep: the same hits and the same kernel rounds' work."""

import numpy as np
import pytest
import torch

import tantivy_tpu_torch as pt
from tantivy_tpu_torch.ops import fused_bool as fb
from tantivy_tpu_torch.ops import ub_sweep as us
from tantivy_tpu_torch.ops.fused_store import FusedStore
from tantivy_tpu_torch.parallel import wand
from tantivy_tpu_torch.postings.format import TERMINATED

import zstd_stub


class _Slab:
    """A synthetic (segment, field) posting table, as `FusedStore.ensure_slab`
    reads one: terms' blocks of 128 sorted docs."""

    def __init__(self, rng, max_doc=24_000, dfs=(20_000, 9_000, 3_000, 700,
                                                 129, 128, 40, 5, 1, 1)):
        scale = max_doc // 24_000
        dfs = [df * scale if df > 128 else df for df in dfs]
        docs, tfs, base, last, mtf, mfn, tbs, tnb = ([] for _ in range(8))
        self.norm_ids_np = rng.integers(0, 256, max_doc).astype(np.uint8)
        for df in dfs:
            d = np.sort(rng.choice(max_doc, size=df, replace=False))
            nb = -(-df // 128)
            tbs.append(len(base))
            tnb.append(nb)
            pad = np.full(nb * 128, TERMINATED, np.uint32)
            pad[:df] = d
            tf = np.zeros(nb * 128, np.uint32)
            # few tf levels, so range maxima tie
            tf[:df] = rng.choice([1, 2, 3, 7], size=df)
            for blk in range(nb):
                row, t = pad[blk * 128:(blk + 1) * 128], tf[blk * 128:
                                                             (blk + 1) * 128]
                live = row != TERMINATED
                base.append(row[0])
                last.append(row[live][-1])
                at = int(np.argmax(t))
                mtf.append(t[at])
                mfn.append(self.norm_ids_np[row[at]])
            docs.append(pad.reshape(nb, 128))
            tfs.append(tf.reshape(nb, 128))
        self.docs_np = np.concatenate(docs)
        self.tfs_np = np.concatenate(tfs)
        self.blk_base = np.array(base, np.uint32)
        self.blk_last_doc = np.array(last, np.uint32)
        self.blk_max_tf = np.array(mtf, np.uint32)
        self.blk_max_fnid = np.array(mfn, np.uint8)
        self.term_block_start = np.array(tbs, np.int64)
        self.term_num_blocks = np.array(tnb, np.int64)
        self.num_blocks = len(base)


def _store(seed, device="cpu", segs=2, max_doc=24_000):
    rng = np.random.default_rng(seed)
    store = FusedStore(device)
    slabs = [_Slab(rng, max_doc) for _ in range(segs)]
    for s, slab in enumerate(slabs):
        store.ensure_slab(s, "body", slab, None, np.float32(37.5))
    store.ready()
    regions = [[store.region(s, "body", t)
                for t in range(len(slab.term_num_blocks))]
               for s, slab in enumerate(slabs)]
    return store, regions, rng


def _calls(rng, regions, n_calls=60, max_clauses=16, empty=False):
    """Planner-shaped calls over one segment's regions each: clause
    positions are indices into a query of T clauses, some absent. With
    `empty`, some regions are emptied: the calls' own alone for "own",
    others' too for True."""
    calls = []
    for _ in range(n_calls):
        seg = regions[int(rng.integers(0, len(regions)))]
        T = int(rng.integers(1, max_clauses + 1))
        present = [c for c in range(T) if c == 0 or rng.random() < 0.85]
        picks = rng.integers(0, len(seg), len(present))
        reg = {c: seg[p] for c, p in zip(present, picks)}
        kind = {c: rng.choice(["must", "should", "must_not"],
                              p=[0.3, 0.55, 0.15]) for c in present}
        w = {c: np.float32(rng.uniform(0.05, 4.0)) for c in present}
        positive = [c for c in present if kind[c] != "must_not"] or [0]
        ci = positive[int(rng.integers(0, len(positive)))]
        if empty:
            for c in present:
                if (c == ci or empty is True) and rng.random() < 0.3:
                    reg[c] = (reg[c][0], 0)
        others = [
            (kind[c] == "must",
             np.float32(0.0) if kind[c] == "must_not" else w[c],
             reg[c][0], reg[c][1], c)
            for c in present if c != ci
        ]
        calls.append((reg[ci][0], reg[ci][1], w[ci], others, ci))
    return calls


def _same(got, want, ctx=""):
    """Two per-call detail dicts equal bit for bit (window columns by
    value, so the per-call version's int64 compares too)."""
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        at = f"{ctx} call {i}"
        assert g["ids"].dtype == np.int64, at
        assert np.array_equal(g["ids"], w["ids"]), at
        assert g["ub"].dtype == np.float32, at
        assert np.array_equal(
            g["ub"].view(np.int32),
            np.asarray(w["ub"], np.float32).view(np.int32)), at
        for key in ("widths", "jlo", "i0", "i1"):
            assert g[key].shape == np.shape(w[key]), (at, key)
            assert np.array_equal(g[key], w[key]), (at, key)
        assert list(g["terms"]) == sorted(w["terms"]), at
        for p, v in w["terms"].items():
            assert np.array_equal(
                g["terms"][p].view(np.int32),
                np.asarray(v, np.float32).view(np.int32)), (at, p)


def _per_call(store, calls):
    return [store.clause_blocks_ub(c[0], c[1], c[2], c[3], self_pos=c[4],
                                   return_detail=True) for c in calls]


def _drops(dets, calls):
    return sum(c[1] - len(d["ids"]) for d, c in zip(dets, calls))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_clauses", [1, 4, 16])
def test_twin_matches_numpy(seed, max_clauses):
    """Off the card the wrapper returns the twin, the numpy batch, which
    equals the per-call version; no row is swept on the card."""
    store, regions, rng = _store(seed)
    calls = _calls(rng, regions, max_clauses=max_clauses)
    got, n_pairs = us.clause_details(store, calls)
    assert n_pairs == 0
    _same(got, wand.batched_clause_details(store, calls), "batched")
    _same(got, _per_call(store, calls), "per call")


def test_cases_cover_the_edges():
    """The drawn cases hold MUST drops, MUST_NOT others, calls with no
    others, one-block regions and windows wider than the widest rung."""
    store, regions, rng = _store(0)
    calls = _calls(rng, regions, max_clauses=16)
    got, _ = us.clause_details(store, calls)
    assert _drops(got, calls) > 0
    assert any(o[1] == 0.0 for c in calls for o in c[3])
    assert any(not c[3] for c in _calls(rng, regions, max_clauses=1))
    assert any(c[1] == 1 for c in calls)
    assert any(o[3] == 1 for c in calls for o in c[3])
    widest = max(int(d["widths"].max(initial=0)) for d in got)
    assert widest > max(fb.fused_kw_max(t) for t in (2, 4, 8, 16))


@pytest.mark.parametrize("seed", [4, 5])
def test_empty_regions_match_per_call(seed):
    """Calls of an empty own region (no rows) beside others; an empty other
    region is the kernel's case alone (`test_kernel_matches_twin_and_numpy_on_cuda`)."""
    store, regions, rng = _store(seed)
    calls = _calls(rng, regions, n_calls=40, max_clauses=6, empty="own")
    assert any(c[1] == 0 for c in calls)
    assert all(o[3] > 0 for c in calls for o in c[3])
    got, _ = us.clause_details(store, calls)
    _same(got, _per_call(store, calls), "per call")


def test_no_calls():
    store, _, _ = _store(0)
    assert us.clause_details(store, []) == ([], 0)
    assert wand.batched_clause_details(store, []) == []


@pytest.mark.parametrize("seed", [6, 7])
def test_twin_matches_the_reference(seed):
    """The reference's numpy planner over the same host tables, with its own
    range-max table."""
    from types import SimpleNamespace

    from tantivy_tpu.parallel import wand as ref_wand

    store, regions, rng = _store(seed)
    calls = _calls(rng, regions, max_clauses=8)
    ref_store = SimpleNamespace(
        blk_base=store.blk_base, blk_last_doc=store.blk_last_doc,
        bfac=store.bfac, region_keys=store.region_keys,
        rmax=ref_wand.RangeMax(store.bfac))
    got, _ = us.clause_details(store, calls)
    _same(got, ref_wand.batched_clause_details(ref_store, calls), "reference")


def test_twin_on_a_store_carried_from_the_reference():
    """A reference executor's store of a real index, carried across with
    `FusedStore.from_jax`: the twin against the reference's planner."""
    import tantivy_tpu as tt
    import tantivy_tpu.parallel as jax_par
    from tantivy_tpu.parallel import wand as ref_wand

    rng = np.random.default_rng(11)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    words = [f"w{i}" for i in range(30)]
    p = 1.0 / np.arange(1, 31)
    w = index.writer_for_tests()
    for _ in range(3):
        for _ in range(400):
            w.add_document(tt.Document(
                body=" ".join(rng.choice(words, 8, p=p / p.sum()))))
        w.commit()
    w.close()
    ref = jax_par.BatchExecutor(index.reader().searcher())
    for seg in range(3):
        ref._ensure_fused_slab(seg, "body")
    ref_store = ref._fused().ready()
    store = FusedStore.from_jax(ref_store, "cpu")
    regions = []
    for seg, reader in enumerate(ref.searcher.segment_readers()):
        ords = [ref._term_ord(seg, reader, "body", x.encode()) for x in words]
        regions.append([store.region(seg, "body", o) for o in ords
                        if o is not None and o >= 0])
    calls = _calls(rng, regions, max_clauses=6)
    got, _ = us.clause_details(store, calls)
    _same(got, ref_wand.batched_clause_details(ref_store, calls), "reference")
    _same(got, wand.batched_clause_details(store, calls), "batched")


def test_sweep_checks_its_inputs():
    store, regions, rng = _store(0)
    pk = us.Packed(_calls(rng, regions, n_calls=3))
    base, last, bfac = store.ub_tables()
    tables = torch.from_numpy(pk.tables)
    with pytest.raises(ValueError):
        us.sweep(base, last, bfac.view(torch.int32), tables, pk.n_calls,
                 pk.n_rows, pk.n_pairs)
    with pytest.raises(ValueError):
        us.sweep(base, last[:-1], bfac, tables, pk.n_calls, pk.n_rows,
                 pk.n_pairs)
    with pytest.raises(ValueError):
        us.sweep(base, last, bfac, tables[:5], pk.n_calls, pk.n_rows,
                 pk.n_pairs)
    n0 = us.launches
    with pytest.raises(ValueError, match="cuda only"):
        us.sweep(base, last, bfac, tables, pk.n_calls, pk.n_rows, pk.n_pairs)
    assert us.launches == n0


def test_smoke_ub_sweep_bytes():
    """The smoke's least bytes of a UB sweep (`chip_smoke.ub_sweep_bytes`):
    the outputs and the packed tables, 8 B of docs for each block of the
    calls' own regions and 4 B of `bfac` for each of those and of the
    range maxima's blocks, each block once however many rows touch it."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    store, _, _ = _store(0)
    one = np.float32(1.0)
    calls = [(0, 10, one, [(False, one, 20, 10, 1)], 0),
             (5, 7, one, [(True, one, 25, 15, 1)], 0)]
    pk = us.Packed(calls)
    P, R = pk.n_pairs, pk.n_rows
    assert (P, R) == (17, 17)
    flat = np.zeros(5 * P + 3 * R, np.int32)
    flat[P:P + 10], flat[2 * P:2 * P + 10] = 20, 30
    flat[P + 10:2 * P], flat[2 * P + 10:3 * P] = 25, 40
    # own blocks [0, 12); bfac over [0, 12) and [20, 40)
    want = 4 * flat.size + 4 * pk.tables.size + 8 * 12 + 4 * (12 + 20)
    assert chip_smoke.ub_sweep_bytes(store, pk, flat) == want


def _index(seed, n_docs=18_000, segs=2):
    """A port index whose terms reach windows wider than the widest rung:
    `a` in every doc, `h` in a third, `r` in a few (built and read with the
    zstandard stand-in where the package is missing, as on the card's
    machine)."""
    rng = np.random.default_rng(seed)
    b = pt.Schema.builder()
    b.add_text_field("body", pt.TEXT)
    index = pt.Index.create_in_ram(b.build())
    w = index.writer_for_tests()
    words = [f"z{i}" for i in range(40)]
    p = 1.0 / np.arange(1, 41)
    for s in range(segs):
        for i in range(n_docs // segs):
            extra = ["a"] + (["h"] if i % 3 == 0 else []) + (
                ["r"] if i % 997 == 5 else [])
            w.add_document(pt.Document(body=" ".join(
                extra + list(rng.choice(words, 6, p=p / p.sum())))))
        w.commit()
    w.close()
    return index.reader().searcher(), ["a", "h", "r"] + words


def _queries(rng, words, n=48):
    occ = {"must": pt.Occur.MUST, "should": pt.Occur.SHOULD,
           "must_not": pt.Occur.MUST_NOT}
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 7))
        picks = rng.choice(len(words), size=k, replace=False)
        kinds = rng.choice(["must", "should", "must_not"], size=k,
                           p=[0.35, 0.55, 0.1])
        if all(x == "must_not" for x in kinds):
            kinds[0] = "should"
        out.append(pt.BooleanQuery([
            (occ[x], pt.TermQuery(pt.Term.from_field_text("body", words[i])))
            for x, i in zip(kinds, picks)]))
    # a rare MUST beside a dense MUST: windows wider than the widest rung,
    # which the planner slices
    for kinds in (("must", "must"), ("must", "must", "should"),
                  ("must", "must", "must_not")):
        out.append(pt.BooleanQuery([
            (occ[x], pt.TermQuery(pt.Term.from_field_text("body", w)))
            for x, w in zip(kinds, ("r", "a", "h"))]))
    return out


def _hit_bits(hits):
    return [[(int(np.float32(s).view(np.int32)), a.segment_ord, a.doc_id)
             for s, a in h] for h in hits]


def test_cpu_executor_sweeps_in_numpy(monkeypatch):
    zstd_stub.use(monkeypatch)
    searcher, words = _index(3, n_docs=1200)
    ex = pt.BatchExecutor(searcher, device="cpu")
    n0 = us.launches
    queries = _queries(np.random.default_rng(3), words, n=24)
    got = ex.search_batch(queries, 10)
    assert ex.plan_stats.get("ub_sweep_card_rows", 0) == 0
    assert ex.plan_stats["ub_blocks"] > 0
    assert us.launches == n0
    for q, hits in zip(queries, got):
        assert hits == searcher.search(q, pt.TopDocs(10)), q


# -- on the card ----------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the UB sweep kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_clauses", [1, 4, 16])
@pytest.mark.parametrize("empty", [False, True])
def test_kernel_matches_twin_and_numpy_on_cuda(seed, max_clauses, empty):
    _cuda()
    store, regions, rng = _store(seed)
    card, _, _ = _store(seed, "cuda")
    calls = _calls(rng, regions, max_clauses=max_clauses, empty=empty)
    n0 = us.launches
    got, n_pairs = us.clause_details(card, calls)
    torch.cuda.synchronize()
    assert us.launches == n0 + 1
    assert n_pairs == sum(c[1] * len(c[3]) for c in calls)
    _same(got, _per_call(store, calls), "per call")
    if not empty:
        _same(got, wand.batched_clause_details(store, calls), "twin")


@pytest.mark.cuda
def test_kernel_at_scale_on_cuda():
    """Thousands of calls over regions of up to 1,563 blocks: about a million
    block rows, a grid of several waves, long range-max scans."""
    _cuda()
    store, regions, rng = _store(8, segs=4, max_doc=240_000)
    card, _, _ = _store(8, "cuda", segs=4, max_doc=240_000)
    calls = _calls(rng, regions, n_calls=4_000, max_clauses=12)
    # three waves of 132 SMs x 8 CTAs of 256 threads, a thread a row
    assert sum(c[1] for c in calls) > 3 * 132 * 8 * 256
    got, n_pairs = us.clause_details(card, calls)
    assert n_pairs == sum(c[1] * len(c[3]) for c in calls)
    _same(got, wand.batched_clause_details(store, calls), "twin")


@pytest.mark.cuda
def test_kernel_with_no_rows_on_cuda():
    _cuda()
    card, regions, rng = _store(0, "cuda")
    assert us.clause_details(card, []) == ([], 0)
    calls = [(regions[0][0][0], 0, np.float32(1.0), [], 0)]
    n0 = us.launches
    got, n_pairs = us.clause_details(card, calls)
    assert n_pairs == 0 and us.launches == n0
    assert len(got) == 1 and len(got[0]["ids"]) == 0


def _run(ex, queries):
    ex.launch_log = []
    hits = ex.search_batch(queries, 10)
    torch.cuda.synchronize()
    log, ex.launch_log = ex.launch_log, None
    return _hit_bits(hits), log


def _same_rounds(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra["kind"] == rb["kind"]
        if ra["kind"] != "bool":
            continue
        assert len(ra["chunks"]) == len(rb["chunks"])
        for ca, cb in zip(ra["chunks"], rb["chunks"]):
            for x, y in zip(ca, cb):
                assert torch.equal(x.cpu(), y.cpu())
        for x, y in zip(ra["tables"], rb["tables"]):
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
def test_executor_sweeps_on_the_card(monkeypatch):
    """One boolean batch on the card with the sweep on the card, then with
    the numpy sweep: the same hits (score bits and addresses), the same
    kernel rounds' work and the same planner counts."""
    _cuda()
    zstd_stub.use(monkeypatch)
    searcher, words = _index(5)
    queries = _queries(np.random.default_rng(5), words)
    card = pt.BatchExecutor(searcher, device="cuda")
    n0 = us.launches
    got, log = _run(card, queries)
    assert us.launches > n0
    assert card.plan_stats["ub_sweep_card_rows"] > 0

    plain = pt.BatchExecutor(searcher, device="cuda")
    monkeypatch.setattr(
        us, "clause_details",
        lambda store, calls: (wand.batched_clause_details(store, calls), 0))
    want, log_np = _run(plain, queries)
    assert got == want
    _same_rounds(log, log_np)
    assert plain.plan_stats.get("ub_sweep_card_rows", 0) == 0
    for key in ("ub_blocks", "wand_p1", "wand_p2"):
        assert card.plan_stats.get(key) == plain.plan_stats.get(key), key
    assert card.plan_stats.get("bool_slice_rows", 0) > 0
    for q, hits in zip(queries, got):
        assert hits == _hit_bits([searcher.search(q, pt.TopDocs(10))])[0], q
