"""The port's merge tails against the reference's XLA ones, scores compared
as f32 bits:

* the seg form's twin (`per_query_topk_rows_seg`, torch) on random
  candidate rows with planted duplicate addresses and score ties, against
  both reference forms (the port keeps only the 5-array one);
* both twins (`per_query_topk_from_rows` too) on every
  `kernel_cases.tail_case`: ties, -inf lanes and qid = Q padding, +0.0 and
  -0.0 in one query, one query of over a hundred 32-row tiles and one of
  none, planted cross-tile duplicates, k above a query's hits;
* `kernel_cases.merge_tail_model`, kernel K8's algorithm in numpy, on the
  same cases, at k around the largest its shared-memory selection holds,
  and with each of its planted faults (`TAIL_MUTATIONS`) caught;
* K8's wrapper (`ops/merge_tail.py`) on CPU tensors (the twin), and the
  executor's tails going through it on both routes.
The `cuda` cases hold K8 against its twin on the card, bitwise, on every
tail case, at the fused chains' shapes and at k up to 2,000 and on both
sides of the largest k its shared-memory selection holds. Inputs are made
from seeds with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_tpu.ops import probe_scorer as ref
from tantivy_tpu.postings.format import TERMINATED
from tantivy_tpu_torch.ops import kernel_cases as kc
from tantivy_tpu_torch.ops import merge_tail as mt
from tantivy_tpu_torch.ops import probe_scorer as port


def _rows(seed, W=96, kk=16, Q=12, n_docs=300):
    rng = np.random.default_rng(seed)
    # few distinct scores -> many ties; small doc space -> duplicates
    levels = rng.uniform(0.5, 9.0, 6).astype(np.float32)
    sc = levels[rng.integers(0, len(levels), (W, kk))]
    dc = rng.integers(0, n_docs, (W, kk)).astype(np.uint32)
    seg = rng.integers(0, 4, W).astype(np.int32)
    qid = rng.integers(0, Q, W).astype(np.int32)
    qid[rng.random(W) < 0.1] = Q          # padding groups
    dead = rng.random((W, kk)) < 0.25     # -inf / TERMINATED fill lanes
    sc[dead] = -np.inf
    dc[dead] = TERMINATED
    # planted duplicate addresses of one query with different scores
    for _ in range(10):
        a, b = rng.integers(0, W, 2)
        qid[b], seg[b] = qid[a], seg[a]
        j = rng.integers(0, kk)
        if dead[a, j]:
            # a kernel never reports TERMINATED with a score; the packed
            # reference form also needs doc < 2^28
            continue
        dc[b, j] = dc[a, j]
        sc[b, j] = np.float32(sc[a, j] if rng.random() < 0.5
                              else levels[rng.integers(0, len(levels))])
    return sc, dc, seg, qid, Q


@pytest.mark.parametrize("pack_addr", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_merge_tail_matches_reference(seed, k, pack_addr):
    """The port's one (5-array) form against each of the reference's two
    forms."""
    sc, dc, seg, qid, Q = _rows(seed)
    want = ref.per_query_topk_rows_seg(
        jnp.asarray(sc), jnp.asarray(dc), jnp.asarray(seg), jnp.asarray(qid),
        k, Q, pack_addr=pack_addr,
    )
    got = port.per_query_topk_rows_seg(
        torch.from_numpy(sc), torch.from_numpy(dc.view(np.int32)),
        torch.from_numpy(seg), torch.from_numpy(qid), k, Q,
    )
    w_sc, w_dc, w_seg = (np.asarray(a) for a in want)
    g_sc, g_dc, g_seg = (a.numpy() for a in got)
    assert np.array_equal(g_sc.view(np.int32), w_sc.view(np.int32))
    assert np.array_equal(g_dc.view(np.uint32), w_dc)
    assert np.array_equal(g_seg, w_seg)
    # the dedup pass really ran: no query lists one address twice
    for q in range(Q):
        addrs = [(s, d) for s, d, v in zip(g_seg[q], g_dc[q], g_sc[q])
                 if v > -np.inf]
        assert len(addrs) == len(set(addrs))


def test_pack_unpack_round_trip():
    sc, dc, seg, qid, Q = _rows(5)
    out = port.per_query_topk_rows_seg(
        torch.from_numpy(sc), torch.from_numpy(dc.view(np.int32)),
        torch.from_numpy(seg), torch.from_numpy(qid), 10, Q,
    )
    vals, docs, segs = port.unpack_results_seg(
        port.pack_results_seg(*out).numpy()
    )
    assert np.array_equal(vals.view(np.int32), out[0].numpy().view(np.int32))
    assert np.array_equal(docs, out[1].numpy().view(np.uint32))
    assert np.array_equal(segs, out[2].numpy())


def test_sortable_desc_round_trip():
    v = np.array([3.5, 0.0, -0.0, 1e-30, -2.0, np.inf, -np.inf, 7.25],
                 dtype=np.float32)
    t = torch.from_numpy(v)
    key = port._sortable_desc(t)
    want = np.asarray(ref._sortable_desc(jnp.asarray(v))).astype(np.int64)
    assert np.array_equal(key.numpy(), want)
    # ascending keys are descending scores, and distinct bits stay distinct
    order = torch.argsort(key, stable=True).numpy()
    assert np.all(np.diff(v[order]) <= 0)
    assert len(set(key.tolist())) == len(v)


# --- kernel K8 (`ops/merge_tail.py`, `csrc/merge_tail.cu`) and its twins

TAIL_KS = (1, 10, 40, 128, 200)
FORMS = ("rows", "seg")


def t(a):
    """numpy -> torch, u32 as int32 bits."""
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32
                                     else a))


def tail_args(case, form, device="cpu"):
    """The wrapper's positional args of a `kernel_cases.tail_case` call in
    `form` (no segments in the rows form)."""
    seg = t(case["row_seg"]).to(device) if form == "seg" else None
    return (t(case["row_sc"]).to(device), t(case["row_doc"]).to(device), seg,
            t(case["qid"]).to(device))


def reference_tail(case, form, k):
    """The reference's merge tail on the case, packed as K8 packs it:
    [2 or 3, Q, k] int32."""
    Q = case["num_queries"]
    sc, dc, qid = (jnp.asarray(case[key])
                   for key in ("row_sc", "row_doc", "qid"))
    if form == "rows":
        out = ref.per_query_topk_from_rows(sc, dc, qid, k, Q)
    else:
        out = ref.per_query_topk_rows_seg(sc, dc, jnp.asarray(case["row_seg"]),
                                          qid, k, Q)
    out = [np.asarray(a) for a in out]
    return np.stack([out[0].view(np.int32)]
                    + [a.astype(np.uint32).view(np.int32) for a in out[1:]])


def bits(hits):
    return [(int(np.float32(s).view(np.int32)), a) for s, a in hits]


def call(form, args, k, Q, **kw):
    sc, dc, seg, qid = args
    if form == "rows":
        return mt.topk_from_rows(sc, dc, qid, k, Q, **kw)
    return mt.topk_rows_seg(sc, dc, seg, qid, k, Q, **kw)


@pytest.mark.parametrize("kk", [32, 128])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", kc.TAIL_KINDS)
def test_twins_match_reference_on_tail_cases(kind, form, kk):
    """Both twins equal the reference's merge tails word for word (f32
    bits, docs, segs) on every tail case: ties, -inf lanes and qid = Q
    padding rows, +0.0 and -0.0 in one query, a query of many tiles and
    one of none, planted cross-row duplicates, fewer hits than k."""
    case = kc.tail_case(kind, kk=kk)
    Q = case["num_queries"]
    for k in TAIL_KS:
        got = mt.twin(*tail_args(case, form), k, Q).numpy()
        assert np.array_equal(got, reference_tail(case, form, k)), k


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", kc.TAIL_KINDS)
def test_numpy_model_of_k8_matches_reference(kind, form):
    """K8's algorithm in numpy (`kernel_cases.merge_tail_model`: tiles of
    8,192 candidates, rounds of 512 filtered against the list's k-th entry
    and the query's shared key, selections over list and buffer with the
    seg form's first-of-address dedup, the cross-tile merge of the tile
    lists filtered on the final shared key) equals the reference, whatever
    order the scatter leaves a query's rows in and its tiles run in (seed
    None: row order, tiles in turn). At kk = 32 "ties", "zeros" and
    "sparse" are small calls (one tile a query, rows in row order), the
    others take the grid kernel's tiles."""
    case = kc.tail_case(kind, kk=32)
    assert kc.tail_small(case["qid"].shape[0], 32, 40,
                         case["num_queries"]) == (
        kind in ("ties", "zeros", "sparse"))
    seg = case["row_seg"] if form == "seg" else None
    for k, seed in ((1, 0), (10, 1), (10, 2), (40, 3), (10, None)):
        got = kc.merge_tail_model(case["row_sc"], case["row_doc"], seg,
                                  case["qid"], k, case["num_queries"],
                                  seed=seed)
        assert np.array_equal(got, reference_tail(case, form, k)), (k, seed)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kk", [32, 128])
def test_numpy_model_keeps_ties_at_the_shared_key(kk, form):
    """"prefix_ties": one query of many tiles whose k-th keys tie in their
    top 64 bits (score and segment) and differ in the third word (the
    doc). The query's shared key is that prefix, its top-k holds entries at
    it, and the cross-tile merge keeps them: the filter drops only entries
    strictly below the shared key."""
    case = kc.tail_case("prefix_ties", kk=kk)
    seg = case["row_seg"] if form == "seg" else None
    stats = {}
    for k in (10, 40):
        got = kc.merge_tail_model(case["row_sc"], case["row_doc"], seg,
                                  case["qid"], k, case["num_queries"],
                                  seed=k, stats=stats)
        want = reference_tail(case, form, k)
        assert np.array_equal(got, want), k
        assert stats["merged_queries"] >= 1
        # the top-k reaches the tied score, below the three above it
        assert (want[0, 0, 3:k] == np.float32(5.0).view(np.int32)).all()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kk", [32, 128])
def test_numpy_model_when_every_candidate_beats_the_threshold(kk, form):
    """"ascending" in row order (seed None, as the scatter's atomics leave
    a warp's rows): every candidate beats the running threshold, so the
    buffer fills every few rounds and the list is selected again and
    again within a tile; the result still equals the reference."""
    case = kc.tail_case("ascending", kk=kk)
    seg = case["row_seg"] if form == "seg" else None
    for k in (10, 128, 700):
        stats = {}
        got = kc.merge_tail_model(case["row_sc"], case["row_doc"], seg,
                                  case["qid"], k, case["num_queries"],
                                  seed=None, stats=stats)
        assert np.array_equal(got, reference_tail(case, form, k)), k
        rows = int((case["qid"] == 0).sum())
        # at least a selection each time the buffer fills
        assert stats["selections"] > rows * kk // kc.tail_sort_size(k)


@pytest.mark.parametrize("form", FORMS)
def test_numpy_model_around_the_shared_memory_k(form):
    """The model at k just under and just over the largest k whose sort
    arrays K8 keeps in shared memory (`TAIL_SMEM_MAX_K`: above it the
    arrays are in global scratch, twice the size): the long query's tiles
    and its cross-tile merge select over lists of thousands."""
    case = kc.tail_case("long", kk=32)
    for k in (kc.TAIL_SMEM_MAX_K, kc.TAIL_SMEM_MAX_K + 1):
        seg = case["row_seg"] if form == "seg" else None
        got = kc.merge_tail_model(case["row_sc"], case["row_doc"], seg,
                                  case["qid"], k, case["num_queries"],
                                  seed=k)
        assert np.array_equal(got, reference_tail(case, form, k)), k
    assert kc.tail_sort_size(kc.TAIL_SMEM_MAX_K) == kc.TAIL_SMEM_MAX_SORT
    assert kc.tail_sort_size(kc.TAIL_SMEM_MAX_K + 1) > kc.TAIL_SMEM_MAX_SORT


#: each planted fault of the model and a call that shows it: (kind, form,
#: kk, k, seed)
MUTATION_CASES = {
    "dedup": ("dups", "seg", 128, 10, 0),
    "final_filter": ("prefix_ties", "seg", 32, 10, 0),
    "flush": ("ascending", "rows", 32, 10, None),
}


@pytest.mark.parametrize("mutate", kc.TAIL_MUTATIONS)
def test_numpy_model_catches_its_mutations(mutate):
    """Each planted fault of the model (keeping each address's last entry,
    a final-key filter that drops entries at the shared key, a buffer
    that drops what it cannot hold instead of selecting first) gives
    another result than the reference on its case, which the faultless
    model matches."""
    kind, form, kk, k, seed = MUTATION_CASES[mutate]
    case = kc.tail_case(kind, kk=kk)
    seg = case["row_seg"] if form == "seg" else None
    want = reference_tail(case, form, k)
    args = (case["row_sc"], case["row_doc"], seg, case["qid"], k,
            case["num_queries"])
    assert np.array_equal(kc.merge_tail_model(*args, seed=seed), want)
    assert not np.array_equal(
        kc.merge_tail_model(*args, seed=seed, mutate=mutate), want)


@pytest.mark.parametrize("k", [200, 300])
def test_numpy_model_above_k_128(k):
    """The model at k above 128: the long query's tiles each fill a list
    of k, and the dups' cross-tile duplicates meet in the cross-tile
    merge."""
    for kind in ("long", "dups"):
        case = kc.tail_case(kind, kk=32)
        for form in FORMS:
            seg = case["row_seg"] if form == "seg" else None
            got = kc.merge_tail_model(case["row_sc"], case["row_doc"], seg,
                                      case["qid"], k, case["num_queries"],
                                      seed=k)
            assert np.array_equal(got, reference_tail(case, form, k)), (
                kind, form)


def test_numpy_model_at_kk_and_k_128():
    """The model at K8's caps, kk = k = 128 (tiles of 64 rows), over the
    cross-tile duplicates of "dups"."""
    case = kc.tail_case("dups", kk=128)
    got = kc.merge_tail_model(case["row_sc"], case["row_doc"],
                              case["row_seg"], case["qid"], 128,
                              case["num_queries"], seed=5)
    assert np.array_equal(got, reference_tail(case, "seg", 128))


@pytest.mark.parametrize("form", FORMS)
def test_signed_zeros_keep_two_keys(form):
    """+0.0 and -0.0 of one query are two scores, +0.0 first; an address
    reported at both keeps +0.0 in the seg form (neither K7's zero fold nor
    the sharded merge's `+ 0.0`). The "zeros" case, and a hand-made query
    of zeros alone."""
    case = kc.tail_case("zeros")
    out = mt.twin(*tail_args(case, form), 40, case["num_queries"]).numpy()
    assert np.array_equal(out, reference_tail(case, form, 40))
    z, nz = 0.0, -0.0
    case = dict(row_sc=np.array([[nz, z, nz, -np.inf], [z, nz, nz, -np.inf],
                                 [nz, z, -np.inf, -np.inf]], np.float32),
                row_doc=np.array([[7, 8, 9, TERMINATED], [7, 9, 3, TERMINATED],
                                  [7, 5, TERMINATED, TERMINATED]], np.uint32),
                row_seg=np.array([1, 1, 0], np.int32),
                qid=np.zeros(3, np.int32), num_queries=1)
    out = mt.twin(*tail_args(case, form), 10, 1).numpy()
    assert np.array_equal(out, reference_tail(case, form, 10))
    sc = out[0, 0]
    n_pos = int((sc == 0).sum())
    n_neg = int((sc == np.float32(nz).view(np.int32)).sum())
    # +0.0 first; the seg form keeps (1, 7) once, at +0.0
    assert (sc[:n_pos] == 0).all() and n_neg
    if form == "seg":
        addrs = list(zip(out[2, 0, :n_pos + n_neg], out[1, 0, :n_pos + n_neg]))
        assert addrs == [(0, 5), (1, 7), (1, 8), (0, 7), (1, 3), (1, 9)]
    else:
        assert (n_pos, n_neg) == (3, 5)


@pytest.mark.parametrize("form", FORMS)
def test_long_query_and_empty_query(form):
    """One query owns most of W = 4,096 rows (over a dozen of K8's
    256-row tiles at kk = 32), another owns none: the empty query's slots
    are -inf / 0 / 0, and the long one's top-k equals the reference's."""
    case = kc.tail_case("long", kk=32)
    assert (case["qid"] == 3).sum() > 12 * kc.tail_tile_rows(32)
    assert not (case["qid"] == 5).any()
    out = mt.twin(*tail_args(case, form), 128, case["num_queries"]).numpy()
    assert np.array_equal(out, reference_tail(case, form, 128))
    assert (out[0, 5] == np.float32(-np.inf).view(np.int32)).all()
    assert not out[1:, 5].any()


@pytest.mark.parametrize("form", FORMS)
def test_k_above_the_hits_pads(form):
    """k larger than a query's hits: the slots past them are -inf, doc 0,
    seg 0."""
    case = kc.tail_case("sparse")
    Q = case["num_queries"]
    out = mt.twin(*tail_args(case, form), 128, Q).numpy()
    assert np.array_equal(out, reference_tail(case, form, 128))
    live = case["row_sc"] > -np.inf
    for q in range(Q):
        hits = int(live[case["qid"] == q].sum())
        assert hits < 128
        pad = out[:, q, hits:]
        assert (pad[0] == np.float32(-np.inf).view(np.int32)).all()
        assert not pad[1:].any()


@pytest.mark.parametrize("form", FORMS)
def test_wrapper_on_cpu_is_the_twin(form):
    """On CPU tensors the wrapper returns the twin's result, launches
    nothing and stores the call's inputs in the round's record (k > 128
    included)."""
    case = kc.tail_case("ties")
    Q = case["num_queries"]
    args = tail_args(case, form)
    for k in (10, 200):
        rec = {"kind": "probe"}
        n0 = mt.launches
        got = call(form, args, k, Q, rec=rec)
        assert torch.equal(got, mt.twin(*args, k, Q))
        assert got.shape == (2 if form == "rows" else 3, Q, k)
        assert mt.launches == n0
        assert rec["kind"] == "probe" and rec["tail"]["form"] == form
        assert rec["tail"]["args"][4:] == (k, Q)


def test_wrapper_checks_its_inputs():
    case = kc.tail_case("ties")
    sc, dc, seg, qid = tail_args(case, "seg")
    Q = case["num_queries"]
    with pytest.raises(ValueError):
        mt.topk_from_rows(sc, dc, qid[:-1], 10, Q)
    with pytest.raises(ValueError):
        mt.topk_rows_seg(sc, dc, seg.long(), qid, 10, Q)
    with pytest.raises(ValueError):
        mt.topk_from_rows(sc.double(), dc, qid, 10, Q)
    wide = torch.zeros((4, 129), dtype=torch.float32)
    with pytest.raises(ValueError):
        mt.topk_from_rows(wide, wide.int(), qid[:4], 10, Q)


def test_wrapper_sends_only_cpu_tensors_to_the_twin(monkeypatch):
    """The twin takes CPU tensors only: tensors on another device raise
    before any launch or twin call, and the twin is never reached from
    the launch path (a CUDA tensor launches the kernel or raises)."""
    case = kc.tail_case("ties")
    Q = case["num_queries"]
    calls = []
    monkeypatch.setattr(mt, "twin", lambda *a: calls.append(a))
    meta = [a.to("meta") if a is not None else None
            for a in tail_args(case, "seg")]
    for form in FORMS:
        with pytest.raises(ValueError):
            call(form, meta, 10, Q)
    assert not calls
    src = __import__("inspect").getsource(mt._tail)
    assert src.count("twin(") == 1
    assert src.index('if dev.type == "cpu":') < src.index("twin(")


@pytest.mark.parametrize("fused", [True, False])
def test_executor_tails_go_through_the_wrapper(fused):
    """Every merge tail of a mixed batch goes through K8's wrapper: each
    kernel round of the launch log holds its tail's inputs under "tail",
    in the seg form on the fused route and the rows form on the
    per-segment route, and each replayed through the twin gives the
    tail's result; hits equal the host engine's."""
    from test_fused_bool import build_zipf_index
    from test_torch_host_parity import port_searcher

    import tantivy_tpu_torch as pt
    from tantivy_tpu_torch import BatchExecutor

    index, words = build_zipf_index()
    ex = BatchExecutor(port_searcher(index), device="cpu", fused=fused)
    ex.launch_log = []
    seen = []
    orig = mt._tail

    def spy(*a):
        out = orig(*a)
        seen.append(out)
        return out

    def q(w):
        return pt.TermQuery(pt.Term.from_field_text("body", w))

    queries = [q(words[0]), q(words[3]),
               pt.BooleanQuery.intersection([q(words[0]), q(words[1])]),
               pt.BooleanQuery.union([q(words[2]), q(words[4])]),
               pt.PhraseQuery("body", [words[0], words[1]])]
    mp = pytest.MonkeyPatch()
    mp.setattr(mt, "_tail", spy)
    try:
        got = ex.search_batch(queries, 10)
    finally:
        mp.undo()
    for qq, g in zip(queries, got):
        assert bits(g) == bits(ex.searcher.search(qq, pt.TopDocs(10)))
    rounds = [rec for rec in ex.launch_log if rec["kind"] != "flat"]
    assert rounds and all("tail" in rec for rec in rounds)
    assert len(rounds) == len(seen)
    assert {rec["tail"]["form"] for rec in rounds} == {
        "seg" if fused else "rows"}
    for rec, out in zip(rounds, seen):
        assert torch.equal(mt.twin(*rec["tail"]["args"]), out)


# --- the kernel itself, on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [32, 128])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", kc.TAIL_KINDS)
def test_kernel_matches_twin_on_cuda(kind, form, kk):
    """K8 against its twin, bitwise, on every tail case at k = 1, 10, 40,
    128 and 200; each call is one launch, of the small kernel where
    `kernel_cases.tail_small` admits the call (ties, zeros and sparse at
    kk = 32), else of the grid kernel."""
    _cuda()
    case = kc.tail_case(kind, kk=kk)
    Q = case["num_queries"]
    want_args = tail_args(case, form)
    args = tail_args(case, form, "cuda")
    for k in TAIL_KS:
        mt.reset_counts()
        got = call(form, args, k, Q)
        torch.cuda.synchronize()
        small = kc.tail_small(case["qid"].shape[0], kk, k, Q)
        assert mt.launches == mt.KERNELS_PER_CALL
        assert mt.launches_by_kernel == {"tail_small" if small else "tail": 1}
        assert torch.equal(got.cpu(), mt.twin(*want_args, k, Q)), k


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(65536, 32, 256), (8192, 128, 256),
                                   (2000, 128, 3), (0, 32, 5)])
def test_kernel_at_real_shapes_on_cuda(form, shape):
    """K8 against its twin at the fused chains' shapes (65,536 rows of 32
    candidates, 8,192 of 128, Q = 256 with qid = Q padding) and at few
    queries of many tiles each; at no row at all (where the twin takes no
    input) every slot is padding."""
    _cuda()
    W, kk, Q = shape
    rng = np.random.default_rng(W + kk)
    sc = rng.uniform(0.5, 9.0, (W, kk)).astype(np.float32)
    sc[rng.random((W, kk)) < 0.5] = -np.inf
    dc = rng.integers(0, 5000, (W, kk)).astype(np.uint32)
    case = dict(row_sc=sc, row_doc=dc,
                row_seg=rng.integers(0, 4, W).astype(np.int32),
                qid=np.where(rng.random(W) < 0.1, Q,
                             rng.integers(0, Q, W)).astype(np.int32),
                num_queries=Q)
    args = tail_args(case, form, "cuda")
    for k in (10, 128, 200):
        got = call(form, args, k, Q).cpu()
        if W == 0:
            assert (got[0] == np.float32(-np.inf).view(np.int32)).all()
            assert not got[1:].any()
        else:
            assert torch.equal(got, mt.twin(*tail_args(case, form), k, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1000, 2000])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["long", "dups", "sparse"])
def test_large_k_runs_the_kernel_on_cuda(kind, form, k):
    """A k far above 128 launches K8 as well (sort arrays of 2,048 and
    4,096 entries in shared memory); bitwise equal to the twin."""
    _cuda()
    case = kc.tail_case(kind, kk=128)
    Q = case["num_queries"]
    n0 = mt.launches
    got = call(form, tail_args(case, form, "cuda"), k, Q)
    torch.cuda.synchronize()
    assert mt.launches - n0 == mt.KERNELS_PER_CALL
    assert torch.equal(got.cpu(), mt.twin(*tail_args(case, form), k, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_kernel_around_the_shared_memory_k_on_cuda(form):
    """K8 at k just under and just over the largest k whose sort arrays it
    keeps in shared memory: the first counts as `tail`, the second as
    `tail_global` (its arrays in global scratch); both bitwise equal to
    the twin."""
    _cuda()
    case = kc.tail_case("long", kk=32)
    Q = case["num_queries"]
    assert mt.smem_max_k() == kc.TAIL_SMEM_MAX_K
    for k, name in ((kc.TAIL_SMEM_MAX_K, "tail"),
                    (kc.TAIL_SMEM_MAX_K + 1, "tail_global")):
        mt.reset_counts()
        got = call(form, tail_args(case, form, "cuda"), k, Q)
        torch.cuda.synchronize()
        assert mt.launches_by_kernel == {name: 1}
        assert torch.equal(got.cpu(), mt.twin(*tail_args(case, form), k, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["long", "dups"])
def test_kernel_across_k_on_cuda(kind, form):
    """K8 against its twin over a sweep of k on queries of many tiles
    (sort arrays of 1,024 to 8,192 entries, lists that fill their sort
    array nearly whole), each call twice: the tiles' shared key makes
    their lists depend on timing, the result must not."""
    _cuda()
    case = kc.tail_case(kind, kk=128)
    Q = case["num_queries"]
    args = tail_args(case, form, "cuda")
    for k in (100, 500, 1500, 1800, 1900, 2000, 2048, 2100, 3000, 4000):
        want = mt.twin(*args, k, Q)
        for _ in range(2):
            assert torch.equal(call(form, args, k, Q), want), k


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_kernel_from_two_threads_on_cuda(form):
    """Calls of two threads at once, each on its own stream, with sort
    arrays of 4,096 and 8,192 entries (more than 48 KB of shared memory,
    which the kernel is opted in to once): each bitwise equal to the
    twin."""
    import threading

    _cuda()
    case = kc.tail_case("long", kk=32)
    Q = case["num_queries"]
    args = tail_args(case, form, "cuda")
    wants = {k: mt.twin(*args, k, Q) for k in (3600, 7000)}
    torch.cuda.synchronize()
    bad = []

    def run(k):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(8):
                got = call(form, args, k, Q)
                stream.synchronize()
                if not torch.equal(got, wants[k]):
                    bad.append(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in wants]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
