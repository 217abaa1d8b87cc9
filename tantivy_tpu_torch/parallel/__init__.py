"""Batched search on the port: term, AND, OR, phrase and phrase-prefix
batches through the reference's two routings, which the caller picks
(`BatchExecutor(..., fused=...)`).

Counterpart of `tantivy_tpu/parallel/__init__.py`'s `BatchExecutor`. Host
planning (termdict lookups, BM25 weights, block-max upper bounds, the
two-phase WAND threshold, hit collection) is the reference's numpy code,
copied into this package (the helpers below, `parallel/wand.py`); only the
launch seam differs, pointing at the port's modules. Five chains run on
the device:
* the fused boolean chain: `_search_boolean_fused` ->
  `fused_bool.launch_fused_bool` -> `fused_bool_topk` -> the group-probe
  kernel (K1) and the merge tail (K8's seg form, `ops/merge_tail.py`);
* the fused phrase chain, for slop-0 phrases and multi-term
  phrase-prefixes: `_search_phrase_fused` ->
  `fused_phrase.launch_fused_phrase` -> `fused_phrase_topk` -> the
  position-probe kernel (K2) and the merge tail (K8's seg form);
* the reference's per-segment Block-WAND boolean path: per (segment,
  field, clause bucket) work lists -> `probe_scorer.dispatch_probe` -> the
  windowed-probe kernel (K3, `bool_probe.bool_probe_topk`) or the deep
  per-lane probe (K4), each with a per-segment merge tail (K8's rows
  form);
* `search_term_batch`, the reference's flat term scorer
  (`ops/flat_scorer.py`): kernel K7's store form (`ops/dense_flat.py`);
* the reference's per-segment Block-WAND phrase path
  (`_search_phrase_seg`): per (segment, field, term count) leader block
  work lists -> `phrase_scorer.dispatch_phrase` -> the per-segment phrase
  kernel (K6, `phrase_scorer.seg_phrase_topk`) with a per-segment merge
  tail (K8's rows form).
All read the same fused store. Which chain a method takes depends on the
executor's route alone, never on its device:
* `fused=True`, the reference's Pallas mode (the dense default):
  `search_batch` sends term, boosted-term and boolean(term) queries (and
  dismax over terms with tie_breaker 0 and single-term phrase-prefixes,
  both expanded into term sub-queries) to the fused boolean chain, and
  slop-0 phrases and multi-term phrase-prefixes to the fused phrase chain;
  `search_boolean_batch` and `search_phrase_batch` run the fused chains;
* `fused=False`, the reference's XLA mode (`_search_batch_segment`):
  `search_batch` sends plain term queries to `search_term_batch` (K7),
  one-field booleans to the per-segment boolean path (K3, K4) and slop-0
  phrases to the per-segment phrase path (K6), and expands nothing;
  `search_boolean_batch` runs the per-segment boolean path (queries whose
  clauses span fields the fused boolean chain inside the same call) and
  `search_phrase_batch` the per-segment phrase path (multi-term
  phrase-prefixes the fused phrase chain inside the same call).
In packed mode (`mode="packed"`, the reference's) no fused store is built
and the route is `fused=False`: `search_term_batch` runs the flat scorer's
packed form, kernel K5 over each (segment, field)'s bit-packed mirror
(`ops/packed_flat.py`), and a batch that would reach a dense-only path
raises.
Sloppy phrases, phrases on fields without positions, phrases longer than
`PHRASE_T_MAX` and every other query type run on the host engine, as in
the reference; phrase-family queries among them are counted in
`host_routed`.

Around them: `search_batches` keeps several batches in flight (a CUDA
stream each), `count_batch` and `agg_batch` answer range counts and
aggregations on the host, `prewarm` and `DeviceSearchWarmer` build a
searcher generation's store and kernels ahead of its first batch, and
`shard.ShardedSearcher` splits the segments over several executors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_index import check_mode, dense_only
from ..ops.fused_store import FusedStore
from ..ops.phrase_scorer import T_MAX as PHRASE_T_MAX
from ..postings.format import TERMINATED as TERMINATED_U32
from ..query.bm25 import Bm25Weight
from ..searcher import DocAddress, Searcher
from ..utils.trace import debug_time, tracer

NEG_INF = np.float32(-np.inf)

#: the `plan_stats` keys the tracer also counts while on, by time, so that a
#: trace can read the planner's share of bounded blocks it shipped
_TRACED_PLAN = ("ub_blocks", "wand_p1", "wand_p2")

#: the kernels `prewarm` loads, by (mode, fused): the route's and, on the
#: fused route, the per-segment paths' too
_ROUTE_KERNELS = {
    ("dense", True): ("group_probe", "phrase_probe", "bool_probe",
                      "deep_probe", "seg_phrase", "dense_flat", "ub_sweep"),
    ("dense", False): ("bool_probe", "deep_probe", "seg_phrase",
                       "dense_flat"),
    ("packed", False): ("packed_flat",),
}

#: phase-2 threshold-ratchet tuning (per-query units): ratchet when more
#: than _RATCHET_MIN_PER_Q * Q work items survive phase 1, shipping the
#: best-UB _RATCHET_TOP_PER_Q * Q items first (tests shrink these to force
#: the two-round path on tiny corpora)
_RATCHET_MIN_PER_Q = 16
_RATCHET_TOP_PER_Q = 8


def _k_eff_quant(v: int) -> int:
    """Quantize a per-row-top-k width to ONE of two ladder values (32, 128).
    The kernel `k` is a static arg; host finalize trims each query's
    chunk to the true k, and per-(launch, query) top-32 ⊇ top-k for any
    k whose dup-inflated width fits 32, so quantizing UP is exact. One
    ladder value per clause bucket = one compiled merge-tail shape
    regardless of the caller's k (the k=3 gate reuses the k=10 programs)."""
    return 32 if v <= 32 else 128


def _k_eff_tb(g, Tb: int, k: int) -> int:
    """Per-row-top-k width: always sized for the dup-capable worst case
    (up to Tb reporters per doc), then quantized (`_k_eff_quant`)."""
    return _k_eff_quant(min(k * Tb, 128))


#: fixed `num_queries` for fused launches. num_queries is a STATIC kernel
#: arg (it sizes the [Q, k] output and the padding sentinel); the planners
#: sub-batch every device batch to at most this many queries, so every
#: launch shares ONE compiled num_queries and expansion (phrase prefix,
#: dismax) can never mint a fresh shape. Padded output rows never receive
#: hits (no work item carries their qid) and cost only bytes in the tail.
_Q_FIXED = 256


def _q_tier(Q: int) -> int:
    assert Q <= _Q_FIXED, "device batch not sub-batched to _Q_FIXED"
    return _Q_FIXED


def _m1() -> int:
    """Phase-1 candidate blocks per (query, segment): more phase-1 work
    buys tighter thresholds and a smaller phase 2 (overridable for
    experiments via TANTIVY_TPU_M1)."""
    import os

    return int(os.environ.get("TANTIVY_TPU_M1", "4"))


def _dedup_hits(hits):
    """In-place: sort by (score desc, DocAddress asc) and drop later
    duplicates of the same DocAddress. Duplicates arise from the fused
    dual-report plan (a skipped-probe lane reports a partial score for a
    doc some full-probing lane also reports); sorting first means the kept
    occurrence carries the max — the exact full — score."""
    hits.sort(key=lambda x: (-float(x[0]), x[1]))
    seen = set()
    out = []
    for h in hits:
        if h[1] not in seen:
            seen.add(h[1])
            out.append(h)
    hits[:] = out


def _sortable_desc_np(v: np.ndarray) -> np.ndarray:
    """u32 key ascending in (f32 value DESCENDING) total order. `+0.0`
    first normalizes -0.0 to +0.0 so bit-keys agree with the host's
    numeric tie semantics (-0.0 == 0.0 ties break by DocAddress)."""
    v = np.ascontiguousarray(v + np.float32(0.0), dtype=np.float32)
    u = v.view(np.uint32)
    s = np.where(
        u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)
    )
    return np.uint32(0xFFFFFFFF) - s


def _dedup_topk_chunks(hits: list, k: int):
    """Per-query hit CHUNKS [(scores f32, segs i32, docs u32), ...] ->
    one chunk sorted (score desc, DocAddress asc), first occurrence per
    address kept (= max score, the fused dual-report semantics), first k.
    The vectorized replacement for the tuple-based `_dedup_hits`."""
    if not hits:
        z = np.zeros(0, dtype=np.float32)
        return z, np.zeros(0, np.int32), np.zeros(0, np.uint32)
    if len(hits) == 1:
        v, s, d = hits[0]
    else:
        v = np.concatenate([h[0] for h in hits])
        s = np.concatenate([h[1] for h in hits])
        d = np.concatenate([h[2] for h in hits])
    order = np.lexsort((d, s, _sortable_desc_np(v)))
    v, s, d = v[order], s[order], d[order]
    addr = (s.astype(np.uint64) << np.uint64(32)) | d.astype(np.uint64)
    _, first = np.unique(addr, return_index=True)
    first.sort()
    sel = first[:k]
    return v[sel], s[sel], d[sel]


def _chunk_hits(hits: list, k: int):
    """Finalize per-query chunks to the public list[(score, DocAddress)]."""
    v, s, d = _dedup_topk_chunks(hits, k)
    return [
        (np.float32(v[i]), DocAddress(int(s[i]), int(d[i])))
        for i in range(len(v))
    ]


def _hits_of(per_query: list, k: int) -> list:
    """Each query's public hit list from its chunks."""
    with debug_time("batch.hits"):
        return [_chunk_hits(hits, k) for hits in per_query]


def _topk_thresholds(per_query, k):
    """(score, seg, doc) thresholds per query from the phase-1 results:
    the kth hit's score AND DocAddress. Blocks whose upper bound ties the
    score can only contribute if they may hold a smaller DocAddress —
    tie-plateaus (ubiquitous under Zipf tf distributions) prune to nearly
    nothing instead of surviving wholesale."""
    Q = len(per_query)
    th = np.full(Q, NEG_INF, dtype=np.float32)
    th_seg = np.full(Q, -1, dtype=np.int64)
    th_doc = np.zeros(Q, dtype=np.int64)
    for qi in range(Q):
        v, s, d = _dedup_topk_chunks(per_query[qi], k)
        per_query[qi] = [(v, s, d)]
        if len(v) == k:
            th[qi] = v[-1]
            th_seg[qi] = s[-1]
            th_doc[qi] = d[-1]
    return th, th_seg, th_doc


def _phase2_keep(ub, blk_base, seg_ord, th, th_seg, th_doc):
    """Phase-2 survivor mask for one query's blocks in one segment.

    Exact compares, no margin: `FieldWand.clause_blocks_ub` guarantees
    `ub >= score` bit-exactly in f32 (UB accumulated in the kernel's clause
    order — see its docstring). So:
      * ub <  th: every doc scores < th — prune.
      * ub == th: a doc can at best TIE the kth hit; it wins only with a
        smaller DocAddress, impossible when the whole block starts after the
        kth hit's address — prune iff later.
      * ub >  th: may hold a strictly better doc — keep.
    """
    if th == NEG_INF:
        return np.ones(len(ub), dtype=bool)
    if seg_ord > th_seg:
        later = np.ones(len(ub), dtype=bool)
    elif seg_ord == th_seg:
        later = blk_base.astype(np.int64) > th_doc
    else:
        later = np.zeros(len(ub), dtype=bool)
    return (ub > th) | ((ub == th) & ~later)


def _route(mode: str, fused: bool | None) -> bool:
    """The executor's routing: True for the fused chains (the reference's
    Pallas mode), False for the per-segment paths and the flat term scorer
    (its XLA mode). None picks the fused chains in dense mode; packed mode
    has none, so `fused=True` there raises."""
    if fused is None:
        return mode == "dense"
    if fused and mode == "packed":
        raise ValueError("fused=True needs mode='dense': packed mode has no "
                         "fused chain")
    return bool(fused)


def _device(device) -> torch.device:
    """`device` as a torch device with its index ("cuda" is the current
    card); raises for CUDA where there is none, so nothing silently moves
    to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the "
            "kernels' plain PyTorch versions"
        )
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


class DeviceSearchWarmer:
    """Warmer (reference `src/reader/warming.rs:14`) that pre-builds the
    device search state of each new searcher generation: the fused slabs
    of `fields` on every segment (and the position store when phrases are
    expected) and, on the first generation, what `BatchExecutor.prewarm`
    prepares for batches like `queries_hint`. The warmed executor is
    stashed on the searcher; `BatchExecutor.for_searcher(searcher)` fetches
    it, so the first batch after a commit pays no upload and no build.
    `device` defaults to "cuda" and must exist; `mode` and `fused` are the
    executor's. In packed mode the warmer builds each field's packed
    mirror on every segment instead of the slabs (the position store is
    dense-only)."""

    def __init__(self, fields: list, queries_hint: list | None = None,
                 k: int = 10, with_positions: bool = False, device="cuda",
                 mode: str = "dense", fused: bool | None = None):
        self.fields = list(fields)
        self.queries_hint = queries_hint
        self.k = k
        self.mode = check_mode(mode)
        self.fused = _route(self.mode, fused)
        if with_positions and mode == "packed":
            raise dense_only("the position store")
        self.with_positions = with_positions
        self.device = _device(device)
        self._prewarmed = False

    def warm(self, searcher) -> None:
        ex = BatchExecutor(searcher, device=self.device, mode=self.mode,
                           fused=self.fused)
        for seg_ord in range(len(searcher.segment_readers())):
            for f in self.fields:
                if self.mode == "packed":
                    ex._flat_scorer(seg_ord, f)
                else:
                    ex._ensure_fused_slab(seg_ord, f)
        if self.mode == "dense":
            ex._warm_store(self.with_positions)
        if self.queries_hint and not self._prewarmed:
            ex.prewarm(self.queries_hint, k=self.k)
            self._prewarmed = True
        searcher._warm_executor = ex


class BatchExecutor:
    """Executes batches of term, boolean(term), phrase and phrase-prefix
    queries on `device`.

    `device` defaults to "cuda" and must exist: nothing silently moves to
    the CPU. On "cpu" every kernel runs its plain PyTorch version.
    `mode` is the reference's: "dense" (decoded rows in the fused store,
    every device path) or "packed" (bit-packed postings on the device,
    decoded per query; only `search_term_batch` runs on the device, and
    the dense-only paths raise).
    `fused` picks the route, as the reference's Pallas mode does: True
    runs the fused chains (kernels K1 and K2), False the per-segment paths
    and the flat term scorer (K3, K4, K6 and K7; the module docstring
    says which method runs what). None means True in dense mode and False
    in packed mode, which has no fused chain."""

    @classmethod
    def for_searcher(cls, searcher: Searcher, device="cuda",
                     mode: str = "dense",
                     fused: bool | None = None) -> "BatchExecutor":
        """The searcher's warmed executor when a `DeviceSearchWarmer` on
        `device` in `mode` on route `fused` ran on this generation (slabs
        or mirrors and kernels ready), else a new executor so made."""
        dev = _device(device)
        fused = _route(check_mode(mode), fused)
        ex = getattr(searcher, "_warm_executor", None)
        if (ex is not None and ex.device == dev and ex.mode == mode
                and ex.fused == fused):
            return ex
        return cls(searcher, device=dev, mode=mode, fused=fused)

    def __init__(self, searcher: Searcher, device="cuda",
                 mode: str = "dense", fused: bool | None = None):
        import threading

        self.searcher = searcher
        self.mode = check_mode(mode)
        #: the route: True the fused chains, False the per-segment paths
        self.fused = _route(self.mode, fused)
        self.device = dev = _device(device)
        # each reader keeps one mirror per mode (the reference's
        # `_device_for` rebuilds it when the mode changes)
        self._device_segments = [
            r.device(mode) for r in searcher.segment_readers()
        ]
        self._field_stats: dict[str, object] = {}
        self._field_wand_cache: dict[tuple[int, str], object] = {}
        self._term_weight_cache: dict[tuple[str, bytes], tuple] = {}
        self._term_ord_cache: dict[tuple[int, str, bytes], int] = {}
        self._fused_store = FusedStore(dev)
        # guards the counters below, which batches in flight on several
        # threads update (`search_batches`)
        self._stats_lock = threading.Lock()
        #: one CUDA stream per batch in flight, made on first use
        self._streams: list = []
        self._flat_scorers: dict[tuple[int, str], object] = {}
        #: phrase-family queries (and expansion sub-queries) answered by the
        #: host engine, as the reference answers them: sloppy, too long, on
        #: a field without positions, or over-truncated prefix expansions
        self.host_routed = 0
        #: (query, segment) plans evaluated on the host engine, by reason
        self.fallbacks: dict[str, int] = {}
        #: planner-branch counters (skip/slice/ratchet, work items)
        self.plan_stats: dict[str, int] = {}
        #: when a list, every kernel round's exact inputs are appended
        self.launch_log: list | None = None

    def _field_statistics(self, field: str):
        fs = self._field_stats.get(field)
        if fs is None:
            fs = self._field_stats[field] = self.searcher.field_statistics(
                field
            )
        return fs

    def _term_weight(self, term) -> tuple:
        key = (term.field, term.value_bytes)
        cached = self._term_weight_cache.get(key)
        if cached is None:
            fs = self._field_statistics(term.field)
            df = self.searcher.doc_freq(term)
            bm25 = Bm25Weight.for_one_term(
                max(df, 1), fs.total_num_docs, fs.average_fieldnorm
            )
            cached = (bm25.weight, bm25.cache)
            self._term_weight_cache[key] = cached
        return cached

    def _term_ord(self, seg_ord: int, reader, field: str, value_bytes: bytes) -> int:
        ckey = (seg_ord, field, value_bytes)
        o = self._term_ord_cache.get(ckey, -2)
        if o == -2:
            o_ = reader.inverted_index(field).term_ord(value_bytes)
            o = -1 if o_ is None else o_
            self._term_ord_cache[ckey] = o
        return o

    # ------------------------------------------------------------------
    # term batches (the flat scorer)

    def _flat_scorer(self, seg_ord: int, field: str):
        """The flat term scorer of one (segment, field): over its slab of
        the fused store, or in packed mode over its packed mirror."""
        from ..ops.flat_scorer import FlatBatchScorer, PackedFlatScorer

        key = (seg_ord, field)
        sc = self._flat_scorers.get(key)
        if sc is None:
            if self.mode == "packed":
                dseg = self._device_segments[seg_ord]
                sc = PackedFlatScorer(dseg.field_postings(field),
                                      dseg.packed_mirror(field, self.device))
            else:
                self._ensure_fused_slab(seg_ord, field)
                sc = FlatBatchScorer(self._fused().slabs[key])
            self._flat_scorers[key] = sc
        return sc

    def search_term_batch(self, terms: list, k: int):
        """Batched term-query top-k with tensorized Block-WAND pruning, on
        the flat scorer (`ops/flat_scorer.py`), as the reference runs it; in
        packed mode on kernel K5 over the packed mirrors.

        Phase 1 scores each query's best block-max blocks everywhere to set a
        per-query threshold; phase 2 scores only blocks whose block-max beats
        it. Exact modulo the reference's own block-max caveat. `terms` are
        `Term`s. Returns list[list[(score, DocAddress)]]. In dense mode a k
        above kernel K7's cap takes its row stage and the merge tail (K8);
        each such flat chunk counts in `plan_stats["flat_rows_k"]`."""
        from ..ops.flat_scorer import dispatch_flat, dispatch_packed_flat

        Q = len(terms)
        if Q == 0:
            return []

        weights_pad = np.zeros(Q + 1, dtype=np.float32)
        caches_pad = np.ones((Q + 1, 256), dtype=np.float32)
        for qi, term in enumerate(terms):
            w, c = self._term_weight(term)
            weights_pad[qi] = w
            caches_pad[qi] = c

        readers = self.searcher.segment_readers()
        by_field: dict[str, list[int]] = {}
        for qi, t in enumerate(terms):
            by_field.setdefault(t.field, []).append(qi)
        if self.mode == "dense":
            for seg_ord in range(len(readers)):
                for field in by_field:
                    self._ensure_fused_slab(seg_ord, field)
            fused = self._fused().ready()

            def dispatch(work):
                # one flat launch per segment: store rows of every field mix
                routes = {}
                outs = dispatch_flat(
                    fused.cstore,
                    np.concatenate([sc.store_rows(b) for sc, b, _ in work]),
                    np.concatenate([q for _, _, q in work]),
                    weights_pad, k, Q, log=self.launch_log, routes=routes,
                )
                if routes.get("rows"):
                    # above K7's cap: its row stage and the merge tail
                    self._count_plan("flat_rows_k", routes["rows"])
                return outs
        else:
            w_dev = torch.from_numpy(weights_pad).to(self.device)
            c_dev = torch.from_numpy(caches_pad).to(self.device)

            def dispatch(work):
                # one launch per (segment, field) chunk: block ids index
                # that field's mirror
                by_scorer: dict = {}
                for sc, b, q in work:
                    by_scorer.setdefault(sc, []).append((b, q))
                return [out for sc, items in by_scorer.items()
                        for out in dispatch_packed_flat(
                            sc.mirror,
                            np.concatenate([b for b, _ in items]),
                            np.concatenate([q for _, q in items]),
                            w_dev, c_dev, k, Q, log=self.launch_log)]

        # host planning: per (segment, query) block lists + bmax scores
        per_seg_rest: dict[int, list] = {}
        pending1 = []
        with debug_time("term.plan_dispatch1"):
            for seg_ord, reader in enumerate(readers):
                work1 = []  # (scorer, blocks, qids)
                rest = []  # (qi, scorer, blocks, bmax)
                for field, qids in by_field.items():
                    scorer = self._flat_scorer(seg_ord, field)
                    for qi in qids:
                        o = self._term_ord(seg_ord, reader, field,
                                           terms[qi].value_bytes)
                        if o < 0:
                            continue
                        ids, bmax = scorer.block_max_scores(
                            o, weights_pad[qi], caches_pad[qi]
                        )
                        self._count_plan("wand_candidates", len(ids))
                        m1 = scorer.m1
                        if len(ids) <= m1:
                            keep = np.ones(len(ids), dtype=bool)
                        else:
                            top = np.argpartition(-bmax, m1 - 1)[:m1]
                            keep = np.zeros(len(ids), dtype=bool)
                            keep[top] = True
                            rest.append(
                                (qi, scorer, ids[~keep], bmax[~keep])
                            )
                        work1.append((scorer, ids[keep], np.full(
                            int(keep.sum()), qi, dtype=np.int32)))
                per_seg_rest[seg_ord] = rest
                if work1:
                    self._count_plan("wand_p1",
                                     sum(len(b) for _, b, _ in work1))
                    pending1.extend(
                        (seg_ord, out) for out in dispatch(work1)
                    )

        # materialize phase 1, establish (score, DocAddress) thresholds
        per_query: list[list] = [[] for _ in range(Q)]
        with debug_time("term.collect1", n=len(pending1)):
            self._collect_flat(pending1, per_query)
        th, th_seg, th_doc = _topk_thresholds(per_query, k)

        # phase 2: surviving blocks only (tie-aware, exact compares)
        pending2 = []
        with debug_time("term.plan_dispatch2"):
            for seg_ord, rest in per_seg_rest.items():
                work2 = []
                for qi, scorer, ids, bmax in rest:
                    keep = _phase2_keep(
                        bmax, scorer.dfp.blk_base[ids], seg_ord,
                        th[qi], th_seg[qi], th_doc[qi],
                    )
                    if not keep.any():
                        continue
                    work2.append((scorer, ids[keep], np.full(
                        int(keep.sum()), qi, dtype=np.int32)))
                if work2:
                    self._count_plan("wand_p2",
                                     sum(len(b) for _, b, _ in work2))
                    pending2.extend(
                        (seg_ord, out) for out in dispatch(work2)
                    )
        with debug_time("term.collect2", n=len(pending2)):
            self._collect_flat(pending2, per_query)

        return _hits_of(per_query, k)

    # ------------------------------------------------------------------
    # boolean batches

    @staticmethod
    def _term_clause(sub):
        """(TermQuery, f32 boost) for device-eligible boolean clauses:
        plain terms and (nested) BoostQuery-wrapped terms — boost folds
        into the clause weight exactly like the host's
        `Bm25Weight.boost_by` (see BoostQuery.weight). None otherwise."""
        from ..query import BoostQuery, TermQuery

        if isinstance(sub, TermQuery):
            return sub, np.float32(1.0)
        if isinstance(sub, BoostQuery):
            tb = sub.term_and_boost()
            # negative boost inverts the block-max inequality (w * bfac_max
            # would LOWER-bound scores), so WAND pruning is unsound — keep
            # such clauses on the host path
            if tb is not None and tb[1] >= np.float32(0.0):
                return tb
        return None

    def _clause_weight(self, sub_term, boost) -> np.float32:
        w = np.float32(self._term_weight(sub_term.term)[0])
        if boost != np.float32(1.0):
            # bitwise-identical to Bm25Weight.boost_by
            w = np.float32(w * np.float32(boost))
        return w

    def _clause_fields(self, q) -> set:
        """The fields of a device-eligible boolean's clauses."""
        return {self._term_clause(sub)[0].term.field for _, sub in q.clauses}

    def _bool_device_eligible(self, q) -> bool:
        from ..query import BooleanQuery

        from ..ops.probe_scorer import T_MAX

        if not isinstance(q, BooleanQuery):
            return False
        if not 1 <= len(q.clauses) <= T_MAX:
            return False
        # the fused store handles clauses across fields
        return all(self._term_clause(sub) is not None for _, sub in q.clauses)

    def _fused(self):
        return self._fused_store

    def _warm_store(self, positions: bool) -> None:
        """Upload the fused store and, on CUDA, the UB sweep's tables
        the fused boolean planner reads; with `positions`, build the
        position store that the route's phrase path reads (the per-segment
        one also reads each row's position offsets)."""
        fused = self._fused().ready()
        if self.fused and fused.device.type == "cuda" and fused.slabs:
            fused.ub_tables()
        if positions and fused.slabs:
            if self.fused:
                fused.ensure_positions()
            else:
                fused.position_tensors()

    def _ensure_fused_slab(self, seg_ord: int, field: str):
        if self.mode == "packed":
            raise dense_only("the fused store")
        fused = self._fused()
        if (seg_ord, field) in fused.slabs:
            return
        # the store's lock serializes slab building (slab offsets are
        # assigned by append order) and this segment's field decode
        with fused.lock:
            if (seg_ord, field) in fused.slabs:
                return
            fs = self._field_statistics(field)
            dseg = self._device_segments[seg_ord]
            fused.ensure_slab(
                seg_ord, field, dseg.field_postings(field), dseg.alive_np,
                fs.average_fieldnorm,
            )

    def _count_fallback(self, kind: str) -> None:
        with self._stats_lock:
            self.fallbacks[kind] = self.fallbacks.get(kind, 0) + 1

    def _count_plan(self, kind: str, n: int = 1) -> None:
        with self._stats_lock:
            self.plan_stats[kind] = self.plan_stats.get(kind, 0) + n
        if tracer.enabled and kind in _TRACED_PLAN:
            tracer.count(f"plan_stats.{kind}", n)

    @staticmethod
    def _prow_tier(n: int, Tb: int = 2) -> int:
        """Plan-row table tier: one value per clause bucket, as in the
        reference (queries are sub-batched to fit it)."""
        if Tb <= 4:
            return 4096
        return 2048 if Tb <= 8 else 1024

    def _host_segment_topk(self, query, seg_ord: int, reader, k: int):
        """Exact host evaluation of one query over one segment, as a hit
        CHUNK (scores, segs, docs arrays) — the per-segment fallback for
        plans the device cannot run soundly."""
        with debug_time("host.segment_topk"):
            weight = query.weight(self.searcher, True)
            res = weight.topk(reader, k)  # alive-filtered, may prune
            docs, scores = res.docs, res.scores
            order = np.lexsort((docs, _sortable_desc_np(scores)))[:k]
        return (
            scores[order].astype(np.float32, copy=False),
            np.full(len(order), seg_ord, dtype=np.int32),
            docs[order].astype(np.uint32, copy=False),
        )

    def _search_boolean_fused(self, queries: list, k: int):
        """Fused-store boolean batch: every (query, segment) plan row across
        all fields rides one kernel round per phase (see
        `ops/fused_store.py` and `fused_bool.fused_bool_topk`).

        Wide probe windows (a sparse clause's block spanning many blocks of
        a dense partner) are handled without host fallbacks in two sound
        ways, both emitting explicit per-item window starts (`jlo`):
        * wide MUST probes are SLICED: the item is replicated with the same
          block/lanes but consecutive `stride`-row windows covering the
          overlap. A matching doc's partner posting lies in exactly one
          region row, so exactly the slice(s) fetching that row satisfy the
          MUST and report the full exact score (adjacent slices overlap by
          the alignment slack, so a doc can double-report with identical
          scores — host dedup-by-address absorbs it). Non-matching slices
          fail the MUST count and report nothing. Per-slice UBs are
          recomputed with the slice's own range-max, so phase-2 pruning
          tightens as the window shrinks.
        * wide SHOULD probes are SKIPPED (jlo = -1, partial scores) and the
          skipped clause is itself shipped in full; the doc's densest
          present positive clause probes everything through narrow windows,
          so some reporting lane always carries the exact full score and
          host dedup keeps the max. (For pure-SHOULD rows the skip is
          restricted to strictly denser clauses, preserving that invariant
          structurally.)
        Rows with any skip/slice lose the single-reporter `fullprobe`
        optimization (every enumerator reports; k_eff is widened for the
        duplicates). Remaining wide cases (wide MUST_NOT probes, two wide
        MUST columns on one item) fall back to exact host evaluation per
        (query, segment), counted in `self.fallbacks`.
        """
        from ..query import Occur

        from ..ops import fused_bool as fb
        from ..ops import probe_scorer as ps
        from ..ops import ub_sweep
        from ..ops.probe_scorer import t_bucket

        Q = len(queries)
        if Q == 0:
            return []
        # plan-row tables: cap Q x n_segments at the (fixed, per-clause-
        # bucket) plan-row tier and sub-batch beyond
        n_segs = max(1, len(self.searcher.segment_readers()))
        max_tb = max(t_bucket(len(q.clauses)) for q in queries)
        if n_segs > self._prow_tier(0, max_tb):
            raise ValueError(
                f"{n_segs} segments exceed the plan-row tier "
                f"{self._prow_tier(0, max_tb)}; merge segments first"
            )
        max_q = min(
            max(1, self._prow_tier(0, max_tb) // n_segs), _Q_FIXED
        )
        if Q > max_q:
            out = []
            for lo in range(0, Q, max_q):
                out.extend(
                    self._search_boolean_fused(queries[lo : lo + max_q], k)
                )
            return out
        _dtw = debug_time("bool.prepare")
        _dtw.__enter__()
        Qp = _q_tier(Q)
        kind_of = {
            Occur.MUST: ps.KIND_MUST,
            Occur.SHOULD: ps.KIND_SHOULD,
            Occur.MUST_NOT: ps.KIND_MUST_NOT,
        }

        qclauses = []  # per query: [(kind, term, weight, field)]
        q_req_must = np.zeros(Q, dtype=np.int32)
        q_req_should = np.zeros(Q, dtype=np.int32)
        q_report_all = np.zeros(Q, dtype=bool)
        for qi, q in enumerate(queries):
            n_must = sum(1 for occ, _ in q.clauses if occ == Occur.MUST)
            n_should = sum(1 for occ, _ in q.clauses if occ == Occur.SHOULD)
            q_req_must[qi] = n_must
            ms = q.minimum_number_should_match
            if n_must == 0:
                ms = max(ms, 1)
            q_req_should[qi] = min(ms, n_should) if n_should else 0
            if n_should and q.minimum_number_should_match > n_should:
                q_req_should[qi] = 1 << 30
            info = []
            for occ, sub in q.clauses:
                tq, boost = self._term_clause(sub)
                w = (
                    np.float32(0.0)
                    if occ == Occur.MUST_NOT
                    else self._clause_weight(tq, boost)
                )
                info.append((kind_of[occ], tq.term, w, tq.term.field))
            qclauses.append(info)
            q_report_all[qi] = n_must == 0 and q_req_should[qi] <= 1

        readers = self.searcher.segment_readers()
        fields = {c[3] for info in qclauses for c in info}
        for seg_ord in range(len(readers)):
            for f in fields:
                self._ensure_fused_slab(seg_ord, f)
        fused = self._fused().ready()

        M1 = _m1()
        per_query: list[list] = [[] for _ in range(Q)]
        per_tb: dict[int, dict] = {}
        _dtw.__exit__(None, None, None)

        _dt1 = debug_time("bool.plan_fused")
        _dt1.__enter__()
        _dtp1 = debug_time("bool.plan_pass1")
        _dtp1.__enter__()
        # pass 1: resolve term regions per (segment, query) and batch-plan
        # EVERY positive clause's UB detail in one vectorized sweep
        plans = []
        ub_calls = []
        det_of: dict[tuple[int, int, int], int] = {}
        for seg_ord, reader in enumerate(readers):
            for qi, info in enumerate(qclauses):
                T = len(info)
                ords = [
                    self._term_ord(seg_ord, reader, c[3], c[1].value_bytes)
                    for c in info
                ]
                if any(
                    c[0] == ps.KIND_MUST and o < 0
                    for c, o in zip(info, ords)
                ):
                    continue
                positive = [
                    ci
                    for ci, (c, o) in enumerate(zip(info, ords))
                    if c[0] in (ps.KIND_MUST, ps.KIND_SHOULD) and o >= 0
                ]
                if not positive:
                    continue
                regions = {
                    ci: fused.region(seg_ord, info[ci][3], ords[ci])
                    for ci in range(T)
                    if ords[ci] >= 0
                }
                musts = [ci for ci in positive if info[ci][0] == ps.KIND_MUST]
                nblk = {ci: regions[ci][1] for ci in regions}
                shipped = (
                    [min(musts, key=lambda ci: nblk[ci])] if musts
                    else list(positive)
                )
                others = {
                    ci: [
                        (
                            info[c2][0] == ps.KIND_MUST,
                            info[c2][2] if c2 in positive else np.float32(0.0),
                            regions[c2][0],
                            regions[c2][1],
                            c2,
                        )
                        for c2 in range(T)
                        if c2 != ci and ords[c2] >= 0
                        and (
                            c2 in positive
                            or info[c2][0] == ps.KIND_MUST_NOT
                        )
                    ]
                    for ci in positive
                }
                for ci in positive:
                    det_of[(seg_ord, qi, ci)] = len(ub_calls)
                    ub_calls.append((
                        regions[ci][0], regions[ci][1], info[ci][2],
                        others[ci], ci,
                    ))
                plans.append((seg_ord, reader, qi, info, T, ords,
                              positive, regions, musts, nblk, shipped,
                              others))
        _dtp1.__exit__(None, None, None)
        # the UB sweep: on a CUDA store one kernel (`ops/ub_sweep.py`), else
        # numpy; both give the same dicts, bit for bit
        with debug_time("bool.plan_details", n=len(ub_calls)):
            dets, n_card = ub_sweep.clause_details(fused, ub_calls)
        self._count_plan("ub_sweep_card_rows", n_card)
        # counted once a batch (`plan_stats`): blocks bounded, candidates,
        # phase-1 blocks
        n_ub = sum(c[1] for c in ub_calls)
        n_cand = n_p1 = 0

        _dtp2 = debug_time("bool.plan_pass2")
        _dtp2.__enter__()
        for (seg_ord, reader, qi, info, T, ords, positive, regions, musts,
             nblk, shipped, others) in plans:
            report_all = bool(q_report_all[qi])
            Tb = ps.t_bucket(T)
            KWMAX = fb.fused_kw_max(Tb)
            # slices step `stride` rows and cover `stride_cov` rows from
            # 8-aligned starts (8-row overlap absorbs alignment slack);
            # stride_cov must fit the widest rung's window rows exactly
            stride = max(8, ((KWMAX - 8) // 8) * 8)
            stride_cov = stride + 8
            staged = []  # (clause, ids, ub, eff_width, jlo, wid [n, Tb])
            fallback = False
            any_skip_row = False
            any_slice_row = False
            ship_set = set(shipped)
            to_ship = list(shipped)
            while to_ship and not fallback:
                ci = to_ship.pop()
                oth = others[ci]
                det = dets[det_of[(seg_ord, qi, ci)]]
                ids, ub = det["ids"], det["ub"]
                n_it = len(ids)
                if not n_it:
                    continue
                # -1 jlo = no window: clause columns with no probe
                # (absent clauses, and the OWN clause — its lane IS the
                # clause, presence by construction). `frc` = true first
                # overlapping row minus the 8-aligned window start: the
                # kernel probes exactly [jlo+frc, jlo+wid).
                jlo = np.full((n_it, Tb), -1, dtype=np.int32)
                wid = np.zeros((n_it, Tb), dtype=np.int32)
                frc = np.zeros((n_it, Tb), dtype=np.int32)
                eff = np.zeros(n_it, dtype=np.int32)
                slice_cols = []  # (oi, c2, wide mask) — wide MUST probes
                for oi, (_, _, _, n2, c2) in enumerate(oth):
                    wcol = det["widths"][:, oi]
                    jlo[:, c2] = det["jlo"][:, oi]
                    wid[:, c2] = wcol
                    frc[:, c2] = det["i0"][:, oi] - det["jlo"][:, oi]
                    wide = wcol > KWMAX
                    if not wide.any():
                        eff = np.maximum(eff, wcol)
                        continue
                    kind2 = info[c2][0]
                    if kind2 == ps.KIND_SHOULD and c2 in positive:
                        if report_all and not (n2, c2) > (nblk[ci], ci):
                            # pure-SHOULD skips must target a strictly
                            # denser clause (full-reporter invariant)
                            fallback = True
                            break
                        jlo[wide, c2] = -1  # skip; ship c2 in full
                        eff = np.maximum(eff, np.where(wide, 0, wcol))
                        any_skip_row = True
                        if c2 not in ship_set:
                            ship_set.add(c2)
                            to_ship.append(c2)
                    elif kind2 == ps.KIND_MUST:
                        slice_cols.append((oi, c2, wide))
                        eff = np.maximum(eff, np.where(wide, 0, wcol))
                    else:  # wide MUST_NOT probe: no sound device plan
                        fallback = True
                        break
                if fallback:
                    break
                if slice_cols:
                    n_wide_cols = np.zeros(n_it, dtype=np.int64)
                    for _, _, wide in slice_cols:
                        n_wide_cols += wide
                    if (n_wide_cols > 1).any():
                        fallback = True  # 2+ wide MUSTs: cross product
                        break
                    any_slice_row = True
                    base_keep = n_wide_cols == 0
                    for oi, c2, wide in slice_cols:
                        rows = np.nonzero(wide)[0]
                        i0a = det["jlo"][rows, oi]
                        i0r = det["i0"][rows, oi]
                        i1r = det["i1"][rows, oi]
                        nsl = -(-(i1r - i0a) // stride)
                        tot = int(nsl.sum())
                        rep = np.repeat(rows, nsl)
                        off = (
                            np.arange(tot, dtype=np.int64)
                            - np.repeat(np.cumsum(nsl) - nsl, nsl)
                        )
                        starts = np.repeat(i0a, nsl) + off * stride
                        jlo_sl = jlo[rep].copy()
                        jlo_sl[:, c2] = starts
                        wid_sl = wid[rep].copy()
                        # clip the slice's probed range to the true
                        # overlap [i0, i1): rows beyond i1 may belong
                        # to the NEXT region (doc ids repeat across
                        # regions -> spurious matches)
                        wid_sl[:, c2] = np.minimum(
                            stride_cov, np.repeat(i1r, nsl) - starts
                        )
                        frc_sl = frc[rep].copy()
                        frc_sl[:, c2] = np.maximum(
                            np.repeat(i0r, nsl) - starts, 0
                        )
                        # per-slice UB: same ordered f32 sum, with this
                        # clause's range-max taken over the slice's
                        # window rows only (tighter, still a bound)
                        n_ub += tot
                        ov = fused.rmax.query(
                            np.maximum(starts, np.repeat(i0r, nsl)),
                            np.minimum(
                                starts + stride_cov, np.repeat(i1r, nsl)
                            ),
                        )
                        w2 = np.float32(info[c2][2])
                        ub_sl = np.zeros(tot, dtype=np.float32)
                        for pos in sorted(det["terms"]):
                            term = (
                                (w2 * ov).astype(np.float32)
                                if pos == c2
                                else det["terms"][pos][rep]
                            )
                            ub_sl = (ub_sl + term).astype(np.float32)
                        eff_sl = np.maximum(eff[rep], stride)
                        # slice windows are intentionally partial: keep
                        # as singleton groups (groupable=False)
                        staged.append(
                            (ci, False, ids[rep], ub_sl, eff_sl, jlo_sl,
                             wid_sl, frc_sl)
                        )
                    if not base_keep.all():
                        ids, ub = ids[base_keep], ub[base_keep]
                        eff, jlo = eff[base_keep], jlo[base_keep]
                        wid, frc = wid[base_keep], frc[base_keep]
                if len(ids):
                    staged.append((ci, True, ids, ub, eff, jlo, wid, frc))
            if fallback:
                per_query[qi].append(
                    self._host_segment_topk(queries[qi], seg_ord, reader, k)
                )
                self._count_fallback("bool_wide")
                continue
            if not staged:
                continue

            # commit the plan row
            g = per_tb.get(Tb)
            if g is None:
                g = per_tb[Tb] = {
                    "rows": [],     # per prow table rows
                    "p1": [],       # work tuples
                    "rest": [],
                }
            prow = len(g["rows"])
            row = {
                "cl_weight": np.zeros(Tb, dtype=np.float32),
                "cl_kind": np.full(Tb, ps.KIND_ABSENT, dtype=np.int32),
                "cl_fullprobe": np.zeros(Tb, dtype=np.int32),
                "req_must": int(q_req_must[qi]),
                "req_should": int(q_req_should[qi]),
            }
            for ci, (c, o) in enumerate(zip(info, ords)):
                if o < 0:
                    continue
                row["cl_weight"][ci] = (
                    0.0 if c[0] == ps.KIND_MUST_NOT else c[2]
                )
                row["cl_kind"][ci] = c[0]
            # fullprobe single-reporter optimization only for plain rows
            # (no skipped probes, no sliced windows): any complexity
            # means dual reports — every enumerator reports, the host
            # dedups by DocAddress keeping the (exact, maximal) score.
            if not any_skip_row and not any_slice_row:
                for ci in ship_set:
                    row["cl_fullprobe"][ci] = 1
            g["rows"].append(row)
            if any_skip_row:
                self._count_plan("bool_skip_rows")
            if any_slice_row:
                self._count_plan("bool_slice_rows")

            # clause-ascending staging order keeps the flat work columns'
            # (prow, clause, block) keys sorted — the native single-pass
            # group collapse (native/probe_plan.cc) requires it
            staged.sort(key=lambda s: s[0])

            # phase-1 = the prow's top-M1 blocks by UB across clauses
            all_ub = np.concatenate([s[3] for s in staged])
            if len(all_ub) <= M1:
                cut = NEG_INF
            else:
                cut = np.partition(all_ub, len(all_ub) - M1)[
                    len(all_ub) - M1
                ]
            taken = 0
            n_cand += sum(len(s[2]) for s in staged)
            for ci, grp, ids, ub, eff, jlo, wid, frc in staged:
                pick = ub >= cut
                extra = int(pick.sum()) - (M1 - taken)
                if extra > 0:
                    selidx = np.nonzero(pick)[0]
                    pick[selidx[len(selidx) - extra:]] = False
                taken += int(pick.sum())
                n_p1 += int(pick.sum())
                if pick.any():
                    g["p1"].append(
                        (prow, qi, seg_ord, ci, grp, ids[pick],
                         eff[pick], jlo[pick], wid[pick], frc[pick])
                    )
                if (~pick).any():
                    g["rest"].append(
                        (prow, qi, seg_ord, ci, grp, ids[~pick],
                         ub[~pick], eff[~pick], jlo[~pick], wid[~pick],
                         frc[~pick])
                    )
        self._count_plan("ub_blocks", n_ub)
        if n_cand:
            self._count_plan("wand_candidates", n_cand)
            self._count_plan("wand_p1", n_p1)
        _dtp2.__exit__(None, None, None)
        _dt1.__exit__(None, None, None)

        def finalize_tables(g, Tb):
            n = len(g["rows"])
            tier = self._prow_tier(n, Tb)
            assert n <= tier, "plan rows exceed the fixed prow tier"
            t = {
                "cl_weight": np.zeros((tier + 1, Tb), np.float32),
                "cl_kind": np.full((tier + 1, Tb), 3, np.int32),
                "cl_shipped": np.zeros((tier + 1, Tb), np.int32),
                "req_must": np.zeros(tier + 1, np.int32),
                "req_should": np.zeros(tier + 1, np.int32),
            }
            t["req_must"][n:] = 1 << 30
            for i, row in enumerate(g["rows"]):
                t["cl_weight"][i] = row["cl_weight"]
                t["cl_kind"][i] = row["cl_kind"]
                t["cl_shipped"][i] = row["cl_fullprobe"]
                t["req_must"][i] = row["req_must"]
                t["req_should"][i] = row["req_should"]
            return t

        def build_work(items):
            blocks = np.concatenate([it[5] for it in items])
            prow = np.concatenate(
                [np.full(len(it[5]), it[0], np.int32) for it in items]
            )
            clause = np.concatenate(
                [np.full(len(it[5]), it[3], np.int32) for it in items]
            )
            width = np.concatenate([it[-4] for it in items])
            qid = np.concatenate(
                [np.full(len(it[5]), it[1], np.int32) for it in items]
            )
            seg = np.concatenate(
                [np.full(len(it[5]), it[2], np.int32) for it in items]
            )
            jlo = np.vstack([it[-3] for it in items])
            wid = np.vstack([it[-2] for it in items])
            frc = np.vstack([it[-1] for it in items])
            grp = np.concatenate(
                [np.full(len(it[5]), bool(it[4])) for it in items]
            )
            return blocks, prow, clause, width, qid, seg, jlo, wid, frc, grp

        def launch(work, tables, k_eff):
            return fb.launch_fused_bool(
                fused, work, tables, k_eff, Qp, log=self.launch_log,
            )

        # ---- phase 1: one fused launch per T-bucket ----------------------
        pending1 = []
        tb_tables = {}
        for Tb, g in per_tb.items():
            with debug_time("bool.tables"):
                tb_tables[Tb] = finalize_tables(g, Tb)
            if not g["p1"]:
                continue
            with debug_time("bool.fused_dispatch1"):
                pending1.extend(launch(
                    build_work(g["p1"]), tb_tables[Tb], _k_eff_tb(g, Tb, k)
                ))
        with debug_time("bool.collect1", n=len(pending1)):
            self._collect_flat(pending1, per_query)
        _dt2 = debug_time("bool.phase2")
        _dt2.__enter__()
        th, th_seg, th_doc = _topk_thresholds(per_query, k)

        # ---- phase 2: survivors only, in up to two UB-ordered rounds ------
        # Threshold RATCHET: when many blocks survive phase 1, ship only the
        # best-UB slice first, re-tighten thresholds from its exact results,
        # and prune the bulk with the tighter bar. Both rounds prune with
        # `_phase2_keep` semantics against thresholds that only ever rise,
        # so exactness is preserved. Phase-2 columns are FLAT: the per-item
        # "rest" tuples are concatenated once per T-bucket, preserving item
        # order, so `_group_work` still sees consecutive groupable runs.
        def _flat_rest(items):
            lens = np.array([len(it[5]) for it in items])

            def rep(idx, dt):
                return np.repeat(
                    np.array([it[idx] for it in items], dtype=dt), lens
                )

            return {
                "prow": rep(0, np.int32),
                "qid": rep(1, np.int32),
                "seg": rep(2, np.int32),
                "clause": rep(3, np.int32),
                "grp": rep(4, bool),
                "ids": np.concatenate([it[5] for it in items]),
                "ub": np.concatenate([it[6] for it in items]),
                "eff": np.concatenate([it[7] for it in items]),
                "jlo": np.vstack([it[8] for it in items]),
                "wid": np.vstack([it[9] for it in items]),
                "frc": np.vstack([it[10] for it in items]),
            }

        def _keep_flat(f, th, th_seg, th_doc):
            """Vectorized `_phase2_keep` over flat columns (same exact
            no-margin compares)."""
            th_q = th[f["qid"]]
            ts_q = th_seg[f["qid"]]
            later = (f["seg"] > ts_q) | (
                (f["seg"] == ts_q)
                & (fused.blk_base[f["ids"]].astype(np.int64)
                   > th_doc[f["qid"]])
            )
            return (
                (th_q == NEG_INF)
                | (f["ub"] > th_q)
                | ((f["ub"] == th_q) & ~later)
            )

        def _sel_flat(f, m):
            idx = np.nonzero(m)[0]
            return {kk_: v.take(idx, axis=0) for kk_, v in f.items()}

        def _work_of(f):
            return (
                f["ids"], f["prow"], f["clause"], f["eff"], f["qid"],
                f["seg"], f["jlo"], f["wid"], f["frc"], f["grp"],
            )

        def _th_tables(Tb, f, th):
            """Per-phase plan tables + row_th: each plan row's CURRENT kth
            score, so the kernel keeps only the survivors (score >= th)."""
            t = tb_tables[Tb]
            rt = np.full(len(t["req_must"]), NEG_INF, dtype=np.float32)
            rt[f["prow"]] = th[f["qid"]]
            return dict(t, row_th=rt)

        surv = {}
        for Tb, g in per_tb.items():
            if not g["rest"]:
                continue
            f = _flat_rest(g["rest"])
            m = _keep_flat(f, th, th_seg, th_doc)
            if m.any():
                surv[Tb] = _sel_flat(f, m)
        total_surv = sum(len(f["ids"]) for f in surv.values())
        ratchet = total_surv > _RATCHET_MIN_PER_Q * Q
        if ratchet:
            self._count_plan("bool_ratchet")
            all_ub = np.concatenate([f["ub"] for f in surv.values()])
            top = min(max(_RATCHET_TOP_PER_Q * Q, 1), len(all_ub))
            cut_a = np.partition(all_ub, len(all_ub) - top)[len(all_ub) - top]
            pending_a = []
            for Tb, f in surv.items():
                sel = f["ub"] >= cut_a
                if not sel.any():
                    continue
                fa = _sel_flat(f, sel)
                self._count_plan("wand_p2", len(fa["ids"]))
                with debug_time("bool.fused_dispatch2a"):
                    pending_a.extend(launch(
                        _work_of(fa), _th_tables(Tb, fa, th),
                        _k_eff_tb(per_tb[Tb], Tb, k),
                    ))
            with debug_time("bool.collect2a", n=len(pending_a)):
                self._collect_flat(pending_a, per_query)
            th, th_seg, th_doc = _topk_thresholds(per_query, k)
            # remainder, re-pruned against the ratcheted thresholds
            new_surv = {}
            for Tb, f in surv.items():
                rest = _sel_flat(f, f["ub"] < cut_a)
                if not len(rest["ids"]):
                    continue
                m = _keep_flat(rest, th, th_seg, th_doc)
                if m.any():
                    new_surv[Tb] = _sel_flat(rest, m)
            surv = new_surv
        _dt2.__exit__(None, None, None)

        pending2 = []
        for Tb, f in surv.items():
            if not len(f["ids"]):
                continue
            self._count_plan("wand_p2", len(f["ids"]))
            with debug_time("bool.fused_dispatch2"):
                pending2.extend(launch(
                    _work_of(f), _th_tables(Tb, f, th),
                    _k_eff_tb(per_tb[Tb], Tb, k),
                ))
        with debug_time("bool.collect2", n=len(pending2)):
            self._collect_flat(pending2, per_query)

        # the plan's per-item arrays are freed here, under a span, and not
        # after the return, where no span would hold the time they take (a
        # large local left out of this list frees after the return, outside
        # every span but the batch's root)
        with debug_time("bool.release"):
            plans = ub_calls = dets = det_of = per_tb = g = None
            surv = new_surv = f = tb_tables = pending1 = pending2 = None
        return _hits_of(per_query, k)

    # ------------------------------------------------------------------
    # per-segment boolean batches (Block-WAND over each segment's store)

    def _field_wand(self, seg_ord: int, field: str):
        """Block-max planning state of one (segment, field), cached."""
        from .wand import FieldWand

        fw = self._field_wand_cache.get((seg_ord, field))
        if fw is None:
            dfp = self._device_segments[seg_ord].field_postings(field)
            avg = self._field_statistics(field).average_fieldnorm
            fw = FieldWand(dfp, avg)
            self._field_wand_cache[(seg_ord, field)] = fw
        return fw

    def search_boolean_batch(self, queries: list, k: int):
        """Batched boolean(term-clause) queries on the device through the
        per-segment probe path with two-phase Block-WAND pruning (the
        reference's non-fused `search_boolean_batch`).

        Phase 1 ships each (query, segment)'s best-UB candidate blocks to
        establish a per-query threshold; phase 2 ships only the remaining
        blocks whose upper bound beats it (see `parallel/wand.py` for the
        bound). Every shipped lane carries its doc's FULL score (probes),
        so chunking and pruning never split correctness across launches.
        Work runs per (segment, field, clause bucket) through
        `probe_scorer.dispatch_probe`: kernel K3 for windowed items, the
        deep per-lane probe for wider ones. The planner is single-field, as
        the reference's: queries whose clauses span fields run the fused
        chain (`_search_boolean_fused`) inside the same call. On the fused
        route (`fused=True`) the whole batch runs the fused chain, as the
        reference's does in Pallas mode. Every query must be a
        device-eligible boolean (term or boosted-term clauses).
        Returns list[list[(score, DocAddress)]]."""
        from ..query import Occur

        from ..ops import probe_scorer as ps

        if self.mode == "packed":
            raise dense_only("search_boolean_batch")
        Q = len(queries)
        if Q == 0:
            return []
        for q in queries:
            if not self._bool_device_eligible(q):
                raise ValueError(
                    f"not a device-eligible boolean(term) query: {q!r}"
                )
        if self.fused:
            return self._search_boolean_fused(queries, k)
        multi = [i for i, q in enumerate(queries)
                 if len(self._clause_fields(q)) > 1]
        if multi:
            out = [None] * Q
            for i, hits in zip(multi, self._search_boolean_fused(
                    [queries[i] for i in multi], k)):
                out[i] = hits
            single = [i for i in range(Q) if out[i] is None]
            for i, hits in zip(single, self.search_boolean_batch(
                    [queries[i] for i in single], k)):
                out[i] = hits
            return out

        kind_of = {
            Occur.MUST: ps.KIND_MUST,
            Occur.SHOULD: ps.KIND_SHOULD,
            Occur.MUST_NOT: ps.KIND_MUST_NOT,
        }
        req_must = np.zeros(Q + 1, dtype=np.int32)
        req_should = np.zeros(Q + 1, dtype=np.int32)
        req_must[Q] = 1 << 30
        qclauses = []  # per query: list[(kind, term, weight)]
        field_of_q: list[str] = []
        for qi, q in enumerate(queries):
            n_must = sum(1 for occ, _ in q.clauses if occ == Occur.MUST)
            n_should = sum(1 for occ, _ in q.clauses if occ == Occur.SHOULD)
            req_must[qi] = n_must
            ms = q.minimum_number_should_match
            if n_must == 0:
                ms = max(ms, 1)
            req_should[qi] = min(ms, n_should) if n_should else 0
            if n_should and q.minimum_number_should_match > n_should:
                req_should[qi] = 1 << 30  # unsatisfiable
            info = []
            for occ, sub in q.clauses:
                tq, boost = self._term_clause(sub)
                if occ == Occur.MUST_NOT:
                    w = np.float32(0.0)
                else:
                    w = self._clause_weight(tq, boost)
                info.append((kind_of[occ], tq.term, np.float32(w)))
            qclauses.append(info)
            field_of_q.append(info[0][1].field)

        readers = self.searcher.segment_readers()
        # the kernels read the fused store: one slab per (segment, field)
        for seg_ord in range(len(readers)):
            for f in set(field_of_q):
                self._ensure_fused_slab(seg_ord, f)
        fused = self._fused().ready()
        M1 = _m1()  # phase-1 candidate blocks per query per segment

        def dispatch(seg_ord, field, blocks, qids, cls, tables, widths):
            with debug_time("bool.probe_dispatch", n=len(blocks)):
                return ps.dispatch_probe(
                    fused, fused.slabs[(seg_ord, field)], blocks, qids, cls,
                    tables, k, Q, widths, log=self.launch_log,
                    count=self._count_plan,
                )

        def tag_phase(n0, phase):
            if self.launch_log is not None:
                for rec in self.launch_log[n0:]:
                    rec["phase"] = phase

        # ---- per-segment planning + phase-1 dispatch --------------------
        per_query: list[list] = [[] for _ in range(Q)]
        pending1 = []
        seg_groups = []  # per segment: {(field, Tb): group dict}
        log0 = len(self.launch_log or ())
        _dt1 = debug_time("bool.plan_dispatch1")
        _dt1.__enter__()
        for seg_ord, reader in enumerate(readers):
            dseg = self._device_segments[seg_ord]
            groups: dict[tuple[str, int], dict] = {}
            for qi, info in enumerate(qclauses):
                field = field_of_q[qi]
                dfp = dseg.field_postings(field)
                fw = self._field_wand(seg_ord, field)
                T = len(info)
                ords = [
                    self._term_ord(seg_ord, reader, field, t.value_bytes)
                    for _, t, _ in info
                ]
                # a missing MUST term => no hits in this segment
                if any(
                    kd == ps.KIND_MUST and o < 0
                    for (kd, _, _), o in zip(info, ords)
                ):
                    continue
                positive = [
                    ci
                    for ci, ((kd, _, _), o) in enumerate(zip(info, ords))
                    if kd in (ps.KIND_MUST, ps.KIND_SHOULD) and o >= 0
                ]
                if not positive:
                    continue
                musts = [
                    ci for ci in positive if info[ci][0] == ps.KIND_MUST
                ]
                nblk = {
                    ci: int(dfp.term_num_blocks[ords[ci]]) for ci in positive
                }
                start = {
                    ci: int(dfp.term_block_start[ords[ci]]) for ci in positive
                }
                if musts:
                    leader = min(musts, key=lambda ci: nblk[ci])
                    shipped = [leader]
                else:
                    shipped = positive

                Tb = ps.t_bucket(T)
                g = groups.get((field, Tb))
                if g is None:
                    g = groups[(field, Tb)] = {
                        "tables": {
                            "cl_weight": np.zeros((Q + 1, Tb), np.float32),
                            "cl_kind": np.full((Q + 1, Tb), ps.KIND_ABSENT,
                                               np.int32),
                            "cl_start": np.zeros((Q + 1, Tb), np.int32),
                            "cl_len": np.zeros((Q + 1, Tb), np.int32),
                            "cl_shipped": np.zeros((Q + 1, Tb), bool),
                            "req_must": req_must,
                            "req_should": req_should,
                        },
                        "p1": [],    # (qi, clause, block_ids, widths)
                        "rest": [],  # (qi, clause, block_ids, ub, widths)
                    }
                tb = g["tables"]
                for ci, ((kd, term, w), o) in enumerate(zip(info, ords)):
                    if o < 0:
                        continue
                    tb["cl_weight"][qi, ci] = (
                        0.0 if kd == ps.KIND_MUST_NOT else w
                    )
                    tb["cl_kind"][qi, ci] = kd
                    tb["cl_start"][qi, ci] = int(dfp.term_block_start[o])
                    tb["cl_len"][qi, ci] = int(dfp.term_num_blocks[o])
                    tb["cl_shipped"][qi, ci] = ci in shipped

                # candidate blocks + upper bounds per shipped clause;
                # MUST_NOT clauses join `others` with weight 0 so their
                # probe windows get sized too
                cand = []  # (clause, ids, ub, widths)
                for ci in shipped:
                    others = [
                        (info[c2][0] == ps.KIND_MUST,
                         info[c2][2] if c2 in positive else np.float32(0.0),
                         int(dfp.term_block_start[ords[c2]]),
                         int(dfp.term_num_blocks[ords[c2]]),
                         c2)
                        for c2 in range(T)
                        if c2 != ci and ords[c2] >= 0
                        and (c2 in positive
                             or info[c2][0] == ps.KIND_MUST_NOT)
                    ]
                    ids, ub, widths = fw.clause_blocks_ub(
                        start[ci], nblk[ci], info[ci][2], others,
                        self_pos=ci,
                    )
                    widths = (
                        widths.max(axis=1)
                        if widths.shape[1]
                        else np.zeros(len(ids), dtype=np.int64)
                    )
                    if len(ids):
                        cand.append((ci, ids, ub, widths))
                if not cand:
                    continue
                self._count_plan(
                    "wand_candidates",
                    sum(len(ids) for _, ids, _, _ in cand),
                )
                # phase-1 = the query's top-M1 blocks by UB across clauses
                all_ub = np.concatenate([ub for _, _, ub, _ in cand])
                if len(all_ub) <= M1:
                    cut = NEG_INF
                else:
                    cut = np.partition(all_ub, len(all_ub) - M1)[
                        len(all_ub) - M1
                    ]
                taken = 0
                for ci, ids, ub, widths in cand:
                    pick = ub >= cut
                    # cap exact ties so phase 1 stays small
                    extra = int(pick.sum()) - (M1 - taken)
                    if extra > 0:
                        sel = np.nonzero(pick)[0]
                        pick[sel[len(sel) - extra:]] = False
                    taken += int(pick.sum())
                    if pick.any():
                        g["p1"].append((qi, ci, ids[pick], widths[pick]))
                    if (~pick).any():
                        g["rest"].append(
                            (qi, ci, ids[~pick], ub[~pick], widths[~pick])
                        )

            for (field, Tb), g in groups.items():
                if not g["p1"]:
                    continue
                blocks = np.concatenate([ids for _, _, ids, _ in g["p1"]])
                qids = np.concatenate(
                    [np.full(len(ids), qi, np.int32)
                     for qi, _, ids, _ in g["p1"]]
                )
                cls = np.concatenate(
                    [np.full(len(ids), ci, np.int32)
                     for _, ci, ids, _ in g["p1"]]
                )
                wds = np.concatenate([wd for _, _, _, wd in g["p1"]])
                self._count_plan("wand_p1", len(blocks))
                for out in dispatch(seg_ord, field, blocks, qids, cls,
                                    g["tables"], wds):
                    pending1.append((seg_ord, out))
            seg_groups.append(groups)
        _dt1.__exit__(None, None, None)
        tag_phase(log0, 1)

        # ---- (score, DocAddress) thresholds from phase 1 -----------------
        with debug_time("bool.collect1", n=len(pending1)):
            self._collect_flat(pending1, per_query)
        th, th_seg, th_doc = _topk_thresholds(per_query, k)

        # ---- phase 2: surviving blocks only (tie-aware) -------------------
        pending2 = []
        log0 = len(self.launch_log or ())
        _dt2 = debug_time("bool.plan_dispatch2")
        _dt2.__enter__()
        for seg_ord, groups in enumerate(seg_groups):
            dseg = self._device_segments[seg_ord]
            for (field, Tb), g in groups.items():
                if not g["rest"]:
                    continue
                dfp = dseg.field_postings(field)
                blks, qids, cls, wds = [], [], [], []
                for qi, ci, ids, ub, widths in g["rest"]:
                    keep = _phase2_keep(
                        ub, dfp.blk_base[ids], seg_ord,
                        th[qi], th_seg[qi], th_doc[qi],
                    )
                    if not keep.any():
                        continue
                    blks.append(ids[keep])
                    qids.append(np.full(int(keep.sum()), qi, np.int32))
                    cls.append(np.full(int(keep.sum()), ci, np.int32))
                    wds.append(widths[keep])
                if not blks:
                    continue
                self._count_plan("wand_p2", sum(len(b) for b in blks))
                for out in dispatch(seg_ord, field, np.concatenate(blks),
                                    np.concatenate(qids),
                                    np.concatenate(cls), g["tables"],
                                    np.concatenate(wds)):
                    pending2.append((seg_ord, out))
        _dt2.__exit__(None, None, None)
        tag_phase(log0, 2)
        with debug_time("bool.collect2", n=len(pending2)):
            self._collect_flat(pending2, per_query)

        return _hits_of(per_query, k)

    # ------------------------------------------------------------------
    # phrase batches

    def _positions_field(self, field: str) -> bool:
        from ..schema import IndexRecordOption

        entry = self.searcher.schema.get_field(field)
        return (
            entry.index_record_option()
            == IndexRecordOption.WITH_FREQS_AND_POSITIONS
        )

    def _phrase_device_eligible(self, q) -> bool:
        from ..query import PhraseQuery

        if type(q) is not PhraseQuery:
            return False
        if q.slop != 0 or not 2 <= len(q.term_bytes) <= PHRASE_T_MAX:
            return False
        return self._positions_field(q.field)

    def _prefix_device_eligible(self, q) -> bool:
        """Multi-term PhrasePrefixQuery rides the fused phrase launch
        directly (per-segment capped expansions as plan rows, see
        `_search_phrase_fused`); single-term prefixes expand to term
        sub-queries in `search_batch` instead."""
        from ..query import PhrasePrefixQuery

        if type(q) is not PhrasePrefixQuery:
            return False
        if not 2 <= len(q.term_bytes) <= PHRASE_T_MAX:
            return False
        return self._positions_field(q.field)

    def _expand_phrase_prefix(self, q):
        """Expand a PhrasePrefixQuery into per-expansion sub-queries for the
        device paths, or None when device expansion can't reproduce the
        host semantics (per-segment truncation at max_expansions).

        Exactness: the host merges expansions with max-score-per-doc. If
        doc d is in the union-max top-k, it is in the top-k of the
        expansion where it attains its max (any doc beating it there beats
        it in the union too), so merging the per-expansion top-k lists with
        dedup-by-address-keep-max is exact."""
        from ..query import PhraseQuery, TermQuery
        from ..schema.term import Term

        prefix = q.term_bytes[-1]
        union: set[bytes] = set()
        for reader in self.searcher.segment_readers():
            td = reader.inverted_index(q.field).termdict
            ords = list(td.prefix_ords(prefix))
            if len(ords) > q.max_expansions:
                return None  # per-segment truncation: host semantics only
            union.update(td.term(o) for o in ords)
        subs = []
        for tb in sorted(union):
            if len(q.term_bytes) == 1:
                subs.append(TermQuery(Term(q.field, tb)))
            else:
                subs.append(PhraseQuery(q.field, q.term_bytes[:-1] + [tb]))
        return subs

    def _phrase_plan_rows(self, q) -> int:
        """Upper bound on the plan rows one phrase(-prefix) query adds: one
        per segment for plain phrases; the per-segment CAPPED expansion
        count for phrase-prefixes (each expansion is its own plan row with
        its own BM25 weight)."""
        from ..query import PhrasePrefixQuery

        readers = self.searcher.segment_readers()
        if type(q) is not PhrasePrefixQuery:
            return max(1, len(readers))
        tot = 0
        for reader in readers:
            td = reader.inverted_index(q.field).termdict
            tot += min(
                len(td.prefix_ords(q.term_bytes[-1])), q.max_expansions
            )
        return max(tot, 1)

    def search_phrase_batch(self, queries: list, k: int):
        """Batched slop-0 phrase and multi-term phrase-prefix queries on the
        device. On the fused route (`fused=True`) every query runs the
        fused chain (`_search_phrase_fused`, kernel K2), as the reference's
        `search_phrase_batch` does in Pallas mode. On the per-segment route
        slop-0 phrases run the per-segment Block-WAND plan
        (`_search_phrase_seg`, kernel K6), the reference's route in XLA
        mode, and multi-term phrase-prefixes, which that plan does not
        take, the fused chain inside the same call. Every query must be
        device-eligible. Returns list[list[(score, DocAddress)]]."""
        from ..query import PhrasePrefixQuery

        if self.mode == "packed":
            raise dense_only("search_phrase_batch")
        for q in queries:
            if not (self._phrase_device_eligible(q)
                    or self._prefix_device_eligible(q)):
                raise ValueError(
                    f"not a device-eligible slop-0 phrase query: {q!r}"
                )
        if self.fused:
            return self._search_phrase_fused(queries, k)
        prefixes = [i for i, q in enumerate(queries)
                    if type(q) is PhrasePrefixQuery]
        if not prefixes:
            return self._search_phrase_seg(queries, k)
        out = [None] * len(queries)
        for i, hits in zip(prefixes, self._search_phrase_fused(
                [queries[i] for i in prefixes], k)):
            out[i] = hits
        rest = [i for i in range(len(queries)) if out[i] is None]
        for i, hits in zip(rest, self._search_phrase_seg(
                [queries[i] for i in rest], k)):
            out[i] = hits
        return out

    def _search_phrase_seg(self, queries: list, k: int):
        """`search_phrase_batch`'s per-segment plan over slop-0
        `PhraseQuery`s (the reference's `search_phrase_batch` off Pallas,
        `tantivy_tpu/parallel/__init__.py:2527-2634`): candidates are the
        rarest (leader) term's blocks, whose upper bound is the phrase
        weight times the leader block's block-max tf factor (phrase tf <=
        leader tf); phase 1 ships each (query, segment)'s best `_m1()`
        blocks, phase 2 the rest whose bound beats the phase-1 threshold.
        Each (segment, field, term count) work list runs through
        `phrase_scorer.dispatch_phrase` (kernel K6), one launch a phase.
        (query, segment) plans the device cannot run soundly resolve on the
        host engine, counted in `fallbacks`: a leader block tf above MAX_P
        ("phrase_seg_leader_tf"), any term's above MAX_OTHER_TF
        ("phrase_seg_partner_tf"); windows of any width run on the device
        (the reference sends those wider than its MAX_KW, 1,024 rows, to
        the host)."""
        from ..ops import phrase_scorer as ph
        from ..schema.term import Term

        Q = len(queries)
        if Q == 0:
            return []
        qweight = np.zeros(Q + 1, dtype=np.float32)
        for qi, q in enumerate(queries):
            fs = self._field_statistics(q.field)
            dfs = [self.searcher.doc_freq(Term(q.field, tb))
                   for tb in q.term_bytes]
            qweight[qi] = Bm25Weight.for_terms(
                dfs, fs.total_num_docs, fs.average_fieldnorm
            ).weight

        readers = self.searcher.segment_readers()
        # the kernel reads the fused store: one slab per (segment, field)
        for seg_ord in range(len(readers)):
            for f in {q.field for q in queries}:
                self._ensure_fused_slab(seg_ord, f)
        fused = self._fused().ready()
        M1 = _m1()

        def dispatch(seg_ord, field, g, blocks, qids, terms, widths):
            with debug_time("phrase_seg.dispatch", n=len(blocks)):
                return ph.dispatch_phrase(
                    fused, fused.slabs[(seg_ord, field)], blocks, qids,
                    terms, g["tables"], k, Q, widths, log=self.launch_log,
                    count=self._count_plan,
                )

        def tag_phase(n0, phase):
            if self.launch_log is not None:
                for rec in self.launch_log[n0:]:
                    rec["phase"] = phase

        # ---- per-segment planning + phase-1 dispatch --------------------
        per_query: list[list] = [[] for _ in range(Q)]
        pending1 = []
        seg_groups = []  # per segment: {(field, T): group dict}
        log0 = len(self.launch_log or ())
        _dt1 = debug_time("phrase_seg.plan_dispatch1")
        _dt1.__enter__()
        for seg_ord, reader in enumerate(readers):
            dseg = self._device_segments[seg_ord]
            groups: dict[tuple[str, int], dict] = {}
            for qi, q in enumerate(queries):
                field = q.field
                dfp = dseg.field_postings(field)
                T = len(q.term_bytes)
                ords = [self._term_ord(seg_ord, reader, field, tb)
                        for tb in q.term_bytes]
                if any(o < 0 for o in ords):
                    continue  # the phrase cannot match in this segment
                starts = [int(dfp.term_block_start[o]) for o in ords]
                nblks = [int(dfp.term_num_blocks[o]) for o in ords]
                top_tf = dfp.ensure_blk_top_tf()
                maxtf = [int(top_tf[s:s + n].max(initial=0))
                         for s, n in zip(starts, nblks)]
                leader = min(range(T), key=lambda t: nblks[t])
                why = None
                if maxtf[leader] > ph.MAX_P:
                    why = "phrase_seg_leader_tf"
                elif any(m > ph.MAX_OTHER_TF for m in maxtf):
                    why = "phrase_seg_partner_tf"
                if why is None:
                    others = [(True, np.float32(0.0), starts[t], nblks[t], t)
                              for t in range(T) if t != leader]
                    ids, ub, widths = self._field_wand(
                        seg_ord, field).clause_blocks_ub(
                            starts[leader], nblks[leader], qweight[qi],
                            others, self_pos=leader)
                    widths = (widths.max(axis=1) if widths.shape[1]
                              else np.zeros(len(ids), dtype=np.int64))
                    if not len(ids):
                        continue
                if why is not None:
                    self._count_fallback(why)
                    with debug_time("phrase_seg.host_plan"):
                        per_query[qi].append(
                            self._host_segment_topk(q, seg_ord, reader, k)
                        )
                    continue
                # one group per term count: the kernel takes T at run time,
                # so no table column pads a shorter phrase (the reference's
                # term buckets give 5-7 term phrases empty columns that
                # reject every lane)
                g = groups.get((field, T))
                if g is None:
                    g = groups[(field, T)] = {
                        "tables": {
                            "q_weight": qweight,
                            "cl_start": np.zeros((Q + 1, T), np.int32),
                            "cl_len": np.zeros((Q + 1, T), np.int32),
                            "cl_shift": np.zeros((Q + 1, T), np.int32),
                            "q_max_tf": np.ones(Q + 1, dtype=np.int64),
                        },
                        "p1": [],    # (qi, leader, block_ids, widths)
                        "rest": [],  # (qi, leader, block_ids, ub, widths)
                    }
                tb = g["tables"]
                mx_off = max(q.offsets)
                for t in range(T):
                    tb["cl_start"][qi, t] = starts[t]
                    tb["cl_len"][qi, t] = nblks[t]
                    tb["cl_shift"][qi, t] = mx_off - q.offsets[t]
                tb["q_max_tf"][qi] = max(tb["q_max_tf"][qi], *maxtf)
                if len(ids) <= M1:
                    g["p1"].append((qi, leader, ids, widths))
                else:
                    top = np.argpartition(-ub, M1 - 1)[:M1]
                    pick = np.zeros(len(ids), dtype=bool)
                    pick[top] = True
                    g["p1"].append((qi, leader, ids[pick], widths[pick]))
                    g["rest"].append(
                        (qi, leader, ids[~pick], ub[~pick], widths[~pick])
                    )

            for (field, _), g in groups.items():
                if not g["p1"]:
                    continue
                blocks = np.concatenate([ids for _, _, ids, _ in g["p1"]])
                qids = np.concatenate([np.full(len(ids), qi, np.int32)
                                       for qi, _, ids, _ in g["p1"]])
                terms = np.concatenate([np.full(len(ids), t, np.int32)
                                        for _, t, ids, _ in g["p1"]])
                wds = np.concatenate([wd for _, _, _, wd in g["p1"]])
                self._count_plan("wand_p1", len(blocks))
                pending1.append(
                    (seg_ord, dispatch(seg_ord, field, g, blocks, qids,
                                       terms, wds)))
            seg_groups.append(groups)
        _dt1.__exit__(None, None, None)
        tag_phase(log0, 1)

        # ---- (score, DocAddress) thresholds from phase 1 -----------------
        with debug_time("phrase_seg.collect", n=len(pending1)):
            self._collect_flat(pending1, per_query)
        th, th_seg, th_doc = _topk_thresholds(per_query, k)

        # ---- phase 2: surviving blocks only (tie-aware) -------------------
        pending2 = []
        log0 = len(self.launch_log or ())
        _dt2 = debug_time("phrase_seg.plan_dispatch2")
        _dt2.__enter__()
        for seg_ord, groups in enumerate(seg_groups):
            dseg = self._device_segments[seg_ord]
            for (field, _), g in groups.items():
                if not g["rest"]:
                    continue
                dfp = dseg.field_postings(field)
                blks, qids, terms, wds = [], [], [], []
                for qi, t, ids, ub, widths in g["rest"]:
                    keep = _phase2_keep(
                        ub, dfp.blk_base[ids], seg_ord,
                        th[qi], th_seg[qi], th_doc[qi],
                    )
                    if not keep.any():
                        continue
                    blks.append(ids[keep])
                    qids.append(np.full(int(keep.sum()), qi, np.int32))
                    terms.append(np.full(int(keep.sum()), t, np.int32))
                    wds.append(widths[keep])
                if not blks:
                    continue
                self._count_plan("wand_p2", sum(len(b) for b in blks))
                pending2.append(
                    (seg_ord, dispatch(seg_ord, field, g,
                                       np.concatenate(blks),
                                       np.concatenate(qids),
                                       np.concatenate(terms),
                                       np.concatenate(wds))))
        _dt2.__exit__(None, None, None)
        tag_phase(log0, 2)
        with debug_time("phrase_seg.collect", n=len(pending2)):
            self._collect_flat(pending2, per_query)

        return _hits_of(per_query, k)

    def _search_phrase_fused(self, queries: list, k: int):
        """Fused phrase batch: the position-probe kernel, one launch round
        per phase (see `ops/fused_phrase.py`). Work items anchor on the
        rarest term's blocks; anchor blocks whose own position slab exceeds
        the anchor cap, or whose partner spans exceed the widest rung, are
        re-anchored through the densest other term (all phrase terms are
        MUSTs, so any term's blocks cover every match in their doc range);
        re-anchoring can double-report docs with identical exact scores,
        which the merge tail's dedup-by-address absorbs. Irreducibly wide
        (query, segment) plans fall back to exact host evaluation (counted
        in `fallbacks["phrase_wide"]`).

        PhrasePrefixQuery rides the SAME launch: each (query, segment,
        expansion) becomes its own plan row (the segment's capped
        `prefix_ords` range in term order, exactly the host truncation)
        carrying that expansion's own BM25 weight; all rows share the
        query's qid and the merge tail's dedup-keep-max realizes the
        union-max expansion semantics exactly."""
        from ..query import PhrasePrefixQuery
        from ..schema.term import Term

        from ..ops import fused_phrase as fp
        from ..ops.probe_scorer import t_bucket

        Q = len(queries)
        if Q == 0:
            return []
        with debug_time("phrase.prepare"):
            readers = self.searcher.segment_readers()
            # plan rows (one per (query, segment, expansion) with all
            # terms present) fill a fixed plan-row tier: sub-batch beyond
            max_tb = max(t_bucket(len(q.term_bytes)) for q in queries)
            tier = self._prow_tier(0, max_tb)
            rows_of = [self._phrase_plan_rows(q) for q in queries]
        if Q > 1 and (Q > _Q_FIXED or sum(rows_of) > tier):
            # greedy row-budget chunking (recursing per chunk)
            out = []
            lo = 0
            acc = 0
            for i in range(Q):
                if i > lo and (acc + rows_of[i] > tier or i - lo >= _Q_FIXED):
                    out.extend(self._search_phrase_fused(queries[lo:i], k))
                    lo, acc = i, 0
                acc += rows_of[i]
            out.extend(self._search_phrase_fused(queries[lo:], k))
            return out
        if rows_of and rows_of[0] > tier and Q == 1:
            # a single query's expansion rows exceed the tier: exact host
            from ..collector import TopDocs

            self._count_fallback("phrase_rows_overflow")
            with debug_time("host.search"):
                return [self.searcher.search(queries[0], TopDocs(k))]
        _dtw = debug_time("phrase.prepare")
        _dtw.__enter__()
        Qp = _q_tier(Q)
        wcache: dict = {}

        def _w_terms(field: str, term_bytes: list[bytes]) -> np.float32:
            key = (field, tuple(term_bytes))
            w = wcache.get(key)
            if w is None:
                fs = self._field_statistics(field)
                dfs = [
                    self.searcher.doc_freq(Term(field, tb))
                    for tb in term_bytes
                ]
                w = wcache[key] = Bm25Weight.for_terms(
                    dfs, fs.total_num_docs, fs.average_fieldnorm
                ).weight
            return w

        for seg_ord in range(len(readers)):
            for f in {q.field for q in queries}:
                self._ensure_fused_slab(seg_ord, f)
        fused = self._fused().ready()
        fused.ensure_positions()
        blk_pos = fused.blk_pos

        M1 = _m1()
        per_query: list[list] = [[] for _ in range(Q)]
        groups: dict[int, dict] = {}  # keyed by n_partners bucket
        _dtw.__exit__(None, None, None)

        def overlaps(ids, s2, n2):
            lo = fused.blk_base[ids].astype(np.uint64)
            hi = fused.blk_last_doc[ids].astype(np.uint64)
            i0 = s2 + np.searchsorted(
                fused.blk_last_doc[s2:s2 + n2], lo, side="left"
            )
            i1 = s2 + np.searchsorted(
                fused.blk_base[s2:s2 + n2], hi, side="right"
            )
            return i0, i1

        def plan_anchor(qw, anchor, regions, offsets, ids):
            """Work columns for anchor-term blocks `ids` (global): returns
            the items dict; `bad` marks a fat anchor slab or an over-wide
            partner span. `qw` = the plan row's phrase weight."""
            T = len(regions)
            n = len(ids)
            lpos = blk_pos[ids].astype(np.int64)
            llen = blk_pos[ids + 1] - lpos
            S = t_bucket(T) - 1
            cpos = np.zeros((n, S), dtype=np.int64)
            clen = np.zeros((n, S), dtype=np.int64)
            delta = np.zeros((n, S), dtype=np.int64)
            drop = np.zeros(n, dtype=bool)
            span = np.zeros(n, dtype=np.int64)
            # UB factor: phrase tf <= every term's tf in the doc, so the
            # anchor's block-max tf-factor AND each partner's windowed
            # block-max both dominate the phrase factor: take the min (all
            # f32, rounding monotone, so `ub >= score` stays bit-exact)
            fac = fused.bfac[ids].copy()
            slot = 0
            for t in range(T):
                if t == anchor:
                    continue
                s2, n2 = regions[t]
                i0, i1 = overlaps(ids, s2, n2)
                drop |= i1 <= i0  # a phrase term is a MUST
                fac = np.minimum(fac, fused.rmax.query(i0, i1))
                p0 = blk_pos[i0]
                p1 = blk_pos[i1]
                cpos[:, slot] = p0
                clen[:, slot] = p1 - p0
                delta[:, slot] = offsets[t] - offsets[anchor]
                span = np.maximum(span, p1 - p0)
                slot += 1
            bad = (llen > fp.ANCHOR_POS_CAP) | (span > fp.PARTNER_POS_CAP)
            ub = (np.float32(qw) * fac).astype(np.float32)
            keep = ~drop
            return {
                "ids": ids[keep], "lpos": lpos[keep], "llen": llen[keep],
                "cpos": cpos[keep], "clen": clen[keep],
                "delta": delta[keep], "span": span[keep], "ub": ub[keep],
                "bad": bad[keep],
                "anchor": np.full(int(keep.sum()), anchor, dtype=np.int64),
            }

        def plan_anchors_batched(calls):
            """Vectorized `plan_anchor` over many (qw, anchor, regions,
            offsets, ids) calls: ONE composite-key searchsorted
            (`FusedStore.region_keys`) replaces the per-(query, segment,
            partner) sub-array searches; per-partner f32 `min` folds are
            exact and commutative, so results equal the per-call loop's."""
            if not calls:
                return []
            ns_ = np.array([len(c[4]) for c in calls], dtype=np.int64)
            offs = np.zeros(len(calls) + 1, dtype=np.int64)
            np.cumsum(ns_, out=offs[1:])
            R = int(offs[-1])
            ids = (np.concatenate([c[4] for c in calls]) if R
                   else np.zeros(0, dtype=np.int64))
            lpos = blk_pos[ids].astype(np.int64)
            llen = blk_pos[ids + 1] - lpos
            lo = fused.blk_base[ids].astype(np.uint64)
            hi = fused.blk_last_doc[ids].astype(np.uint64)
            S_max = 1
            p_call, p_slot, p_s2, p_delta = [], [], [], []
            for c_i, (_, anchor, regions, offsets_, _) in enumerate(calls):
                T = len(regions)
                S_max = max(S_max, t_bucket(T) - 1)
                slot = 0
                for t in range(T):
                    if t == anchor:
                        continue
                    p_call.append(c_i)
                    p_slot.append(slot)
                    p_s2.append(regions[t][0])
                    p_delta.append(offsets_[t] - offsets_[anchor])
                    slot += 1
            cpos = np.zeros((R, S_max), dtype=np.int64)
            clen = np.zeros((R, S_max), dtype=np.int64)
            delta = np.zeros((R, S_max), dtype=np.int64)
            drop = np.zeros(R, dtype=bool)
            span = np.zeros(R, dtype=np.int64)
            fac = fused.bfac[ids].copy()
            if p_call:
                p_call_a = np.array(p_call, dtype=np.int64)
                cnt = ns_[p_call_a]
                pofs = np.zeros(len(p_call_a) + 1, dtype=np.int64)
                np.cumsum(cnt, out=pofs[1:])
                P = int(pofs[-1])
                rix = (
                    np.repeat(offs[p_call_a] - pofs[:-1], cnt)
                    + np.arange(P, dtype=np.int64)
                )
                sh = np.uint64(32)
                rid = np.repeat(np.array(p_s2, dtype=np.uint64), cnt) << sh
                cblast, cbbase = fused.region_keys
                i0 = np.searchsorted(cblast, rid | lo[rix], side="left")
                i1 = np.searchsorted(cbbase, rid | hi[rix], side="right")
                bad_ov = i1 <= i0
                if bad_ov.any():
                    drop[rix[bad_ov]] = True
                ov = fused.rmax.query(i0, i1)
                p0 = blk_pos[i0]
                p1 = blk_pos[i1]
                col = np.repeat(np.array(p_slot, dtype=np.int64), cnt)
                cpos[rix, col] = p0
                clen[rix, col] = p1 - p0
                delta[rix, col] = np.repeat(
                    np.array(p_delta, dtype=np.int64), cnt
                )
                for s_i in range(S_max):
                    sel = col == s_i
                    if not sel.any():
                        continue
                    r_s = rix[sel]
                    fac[r_s] = np.minimum(fac[r_s], ov[sel])
                    span[r_s] = np.maximum(span[r_s], (p1 - p0)[sel])
            qw_rows = np.repeat(
                np.array([np.float32(c[0]) for c in calls],
                         dtype=np.float32),
                ns_,
            )
            ub = (qw_rows * fac).astype(np.float32)
            bad = (llen > fp.ANCHOR_POS_CAP) | (span > fp.PARTNER_POS_CAP)
            anchors = np.repeat(
                np.array([c[1] for c in calls], dtype=np.int64), ns_
            )
            out = []
            for c_i, (_, _, regions, _, _) in enumerate(calls):
                s, e = int(offs[c_i]), int(offs[c_i + 1])
                keep = ~drop[s:e]
                S = t_bucket(len(regions)) - 1

                def cut(a):
                    part = a[s:e]
                    return part[keep] if not keep.all() else part

                out.append({
                    "ids": cut(ids), "lpos": cut(lpos), "llen": cut(llen),
                    "cpos": cut(cpos)[:, :S], "clen": cut(clen)[:, :S],
                    "delta": cut(delta)[:, :S], "span": cut(span),
                    "ub": cut(ub), "bad": cut(bad), "anchor": cut(anchors),
                })
            return out

        _dtp = debug_time("phrase.plan")
        _dtp.__enter__()
        phrase_plans = []
        anchor_calls = []
        for seg_ord, reader in enumerate(readers):
            for qi, q in enumerate(queries):
                field = q.field
                T = len(q.term_bytes)
                is_prefix = type(q) is PhrasePrefixQuery
                fixed = q.term_bytes[:-1] if is_prefix else q.term_bytes
                ords = [
                    self._term_ord(seg_ord, reader, field, tb) for tb in fixed
                ]
                if any(o < 0 for o in ords):
                    continue
                offsets = list(range(T)) if is_prefix else q.offsets
                if is_prefix:
                    # one plan row per CAPPED expansion (host truncation
                    # semantics: first max_expansions ords in term order,
                    # per segment)
                    td = reader.inverted_index(field).termdict
                    exp_ords = list(
                        td.prefix_ords(q.term_bytes[-1])
                    )[:q.max_expansions]
                    expansions = [(eo, td.term(eo)) for eo in exp_ords]
                else:
                    expansions = [(ords[-1], None)]
                    ords = ords[:-1]
                for eo, etb in expansions:
                    regions = [
                        fused.region(seg_ord, field, o) for o in ords
                    ] + [fused.region(seg_ord, field, eo)]
                    if is_prefix:
                        w = _w_terms(field, fixed + [etb])
                    else:
                        w = _w_terms(field, q.term_bytes)
                    leader = min(range(T), key=lambda t: regions[t][1])
                    s0, n0 = regions[leader]
                    anchor_calls.append((
                        w, leader, regions, offsets,
                        np.arange(s0, s0 + n0, dtype=np.int64),
                    ))
                    phrase_plans.append(
                        (seg_ord, reader, qi, q, T, regions, leader, w,
                         offsets)
                    )
        batched = plan_anchors_batched(anchor_calls)
        # counted once a batch (`plan_stats`): blocks bounded, re-anchored
        # plans, candidates, phase-1 blocks
        n_ub = sum(len(c[4]) for c in anchor_calls)
        n_reanchor = n_cand = n_p1 = 0

        fell: set = set()  # (qi, seg_ord) already host-fallbacked
        pending_rows: dict[int, list] = {}  # qi -> [(Sb, prow, seg, staged)]
        for (seg_ord, reader, qi, q, T, regions, leader, w, offsets), \
                plan in zip(phrase_plans, batched):
            if (qi, seg_ord) in fell:
                continue
            staged = [(leader, plan)]
            fallback = False
            if plan["bad"].any():
                others_nblk = [
                    (regions[t][1], t) for t in range(T) if t != leader
                ]
                t_alt = max(others_nblk)[1]
                s2, n2 = regions[t_alt]
                bad_ids = plan["ids"][plan["bad"]]
                # doc-level alt-block selection: when the bad anchor blocks
                # are few (a rare term whose sparse blocks span the whole
                # segment, as every phrase-prefix expansion does), decode
                # their doc ids from the slab's host cstore and keep only
                # alt blocks CONTAINING one, instead of every alt block in
                # the doc-range overlap. Exact: a phrase match needs all
                # terms in the doc, so a matching doc's alt block always
                # holds one of these docs.
                if len(bad_ids) <= 64:
                    slab = fused.slabs[(seg_ord, q.field)]
                    local = bad_ids - slab["offset"]
                    docs = slab["cstore"][local, 0:128].ravel()
                    docs = docs[docs != TERMINATED_U32]
                    lastd = fused.blk_last_doc[s2:s2 + n2]
                    j = s2 + np.searchsorted(lastd, docs)
                    union = np.unique(j[j < s2 + n2]).astype(np.int64)
                else:
                    i0, i1 = overlaps(bad_ids, s2, n2)
                    union = np.unique(
                        np.concatenate(
                            [np.arange(a, b) for a, b in zip(i0, i1)]
                            or [np.zeros(0, dtype=np.int64)]
                        )
                    )
                plan2 = plan_anchor(w, t_alt, regions, offsets, union)
                n_ub += len(union)
                if plan2["bad"].any():
                    fallback = True
                else:
                    # drop the bad originals; the re-anchored items cover them
                    good = ~plan["bad"]
                    plan = {kk_: vv[good] for kk_, vv in plan.items()}
                    staged = [(leader, plan), (t_alt, plan2)]
                    n_reanchor += 1
            if fallback:
                # once per (query, segment): the host result is the exact
                # union-max over ALL expansions, so any expansion rows of
                # this pair already staged stay sound (dedup keeps max)
                fell.add((qi, seg_ord))
                per_query[qi].append(
                    self._host_segment_topk(q, seg_ord, reader, k)
                )
                self._count_fallback("phrase_wide")
                continue
            if sum(len(p["ids"]) for _, p in staged) == 0:
                continue

            Sb = t_bucket(T) - 1
            g = groups.get(Sb)
            if g is None:
                g = groups[Sb] = {"qw_rows": [], "p1": [], "rest": []}
            prow = len(g["qw_rows"])
            g["qw_rows"].append(w)
            n_cand += sum(len(p["ids"]) for _, p in staged)
            pending_rows.setdefault(qi, []).append(
                (Sb, prow, seg_ord, staged)
            )

        # phase-1 slice with a per-QUERY budget: M1 best-UB items per
        # (query, segment-with-rows) shared ACROSS the query's plan rows (a
        # phrase-prefix has one row per (segment, expansion)). Phase 2
        # prunes the remainder against exact thresholds, so results do not
        # depend on the split.
        for qi, rows in pending_rows.items():
            segs_q = {so for _, _, so, _ in rows}
            budget = M1 * max(len(segs_q), 1)
            all_ub = np.concatenate(
                [p["ub"] for _, _, _, staged in rows for _, p in staged]
            )
            if len(all_ub) <= budget:
                cut = NEG_INF
            else:
                cut = np.partition(all_ub, len(all_ub) - budget)[
                    len(all_ub) - budget
                ]
            taken = 0
            for Sb, prow, seg_ord, staged in rows:
                g = groups[Sb]
                for _, p in staged:
                    pick = p["ub"] >= cut
                    extra = int(pick.sum()) - (budget - taken)
                    if extra > 0:
                        selidx = np.nonzero(pick)[0]
                        pick[selidx[len(selidx) - extra:]] = False
                    taken += int(pick.sum())
                    n_p1 += int(pick.sum())
                    for name, sel in (("p1", pick), ("rest", ~pick)):
                        if sel.any():
                            g[name].append(
                                (prow, qi, seg_ord,
                                 {kk_: vv[sel] for kk_, vv in p.items()})
                            )
        self._count_plan("ub_blocks", n_ub)
        if n_reanchor:
            self._count_plan("phrase_reanchor", n_reanchor)
        if n_cand:
            self._count_plan("wand_candidates", n_cand)
            self._count_plan("wand_p1", n_p1)

        def build_work(items):
            cols = {
                key: np.concatenate([p[key] for _, _, _, p in items])
                for key in ("ids", "lpos", "llen", "cpos", "clen", "delta",
                            "anchor")
            }

            def per_item(i):
                return np.concatenate([
                    np.full(len(it[3]["ids"]), it[i], np.int32)
                    for it in items
                ])

            return (
                cols["ids"], per_item(0), per_item(1), per_item(2),
                cols["lpos"], cols["llen"], cols["cpos"], cols["clen"],
                cols["delta"], cols["anchor"],
            )

        def launch(items, qw_table, Sb, row_th=None):
            return fp.launch_fused_phrase(
                fused, build_work(items), qw_table, Sb,
                _k_eff_quant(min(2 * k, 128)), Qp, row_th=row_th,
                log=self.launch_log,
            )

        def th_table(qw_table, items, th):
            rt = np.full(len(qw_table), NEG_INF, dtype=np.float32)
            for prow, qi, _, _ in items:
                rt[prow] = th[qi]
            return rt

        _dtp.__exit__(None, None, None)
        pending1 = []
        tb_qw = {}
        with debug_time("phrase.dispatch1"):
            for Sb, g in groups.items():
                # the plan-row table is padded to the fixed tier, as the
                # boolean path's tables are
                tier = self._prow_tier(len(g["qw_rows"]), Sb + 1)
                if len(g["qw_rows"]) > tier:
                    raise AssertionError(
                        "plan rows exceed the fixed prow tier"
                    )
                qw_table = np.zeros(tier + 1, dtype=np.float32)
                qw_table[:len(g["qw_rows"])] = g["qw_rows"]
                tb_qw[Sb] = qw_table
                if g["p1"]:
                    pending1.extend(launch(g["p1"], qw_table, Sb))
        with debug_time("phrase.collect1", n=len(pending1)):
            self._collect_flat(pending1, per_query)
        _dt2 = debug_time("phrase.phase2")
        _dt2.__enter__()
        th, th_seg, th_doc = _topk_thresholds(per_query, k)

        # phase 2 with the same threshold RATCHET as the boolean path: when
        # many anchor blocks survive (phrase UBs are loose: UB assumes
        # phrase tf = leader tf), ship the best-UB slice, re-tighten, then
        # prune the bulk. Thresholds only rise, so pruning stays exact.
        def _keep_groups(groups_rest, th, th_seg, th_doc):
            out = {}
            for Sb, rest in groups_rest.items():
                kept = []
                for prow, qi, seg_ord, p in rest:
                    keep = _phase2_keep(
                        p["ub"], fused.blk_base[p["ids"]], seg_ord,
                        th[qi], th_seg[qi], th_doc[qi],
                    )
                    if keep.any():
                        kept.append(
                            (prow, qi, seg_ord,
                             {kk_: vv[keep] for kk_, vv in p.items()})
                        )
                out[Sb] = kept
            return out

        surv = _keep_groups(
            {Sb: g["rest"] for Sb, g in groups.items()}, th, th_seg, th_doc
        )
        total_surv = sum(
            len(p["ids"]) for items in surv.values() for _, _, _, p in items
        )
        if total_surv > _RATCHET_MIN_PER_Q * Q:
            self._count_plan("phrase_ratchet")
            all_ub = np.concatenate(
                [p["ub"] for items in surv.values() for _, _, _, p in items]
            )
            top = min(max(_RATCHET_TOP_PER_Q * Q, 1), len(all_ub))
            cut_a = np.partition(all_ub, len(all_ub) - top)[len(all_ub) - top]
            pending_a = []
            remainder = {}
            with debug_time("phrase.dispatch2a"):
                for Sb, items in surv.items():
                    round_a, rest = [], []
                    for prow, qi, seg_ord, p in items:
                        sel = p["ub"] >= cut_a
                        if sel.any():
                            round_a.append(
                                (prow, qi, seg_ord,
                                 {kk_: vv[sel] for kk_, vv in p.items()})
                            )
                        if (~sel).any():
                            rest.append(
                                (prow, qi, seg_ord,
                                 {kk_: vv[~sel] for kk_, vv in p.items()})
                            )
                    remainder[Sb] = rest
                    if round_a:
                        self._count_plan(
                            "wand_p2",
                            sum(len(p["ids"]) for _, _, _, p in round_a),
                        )
                        pending_a.extend(launch(
                            round_a, tb_qw[Sb], Sb,
                            th_table(tb_qw[Sb], round_a, th),
                        ))
            with debug_time("phrase.collect2a", n=len(pending_a)):
                self._collect_flat(pending_a, per_query)
            th, th_seg, th_doc = _topk_thresholds(per_query, k)
            surv = _keep_groups(remainder, th, th_seg, th_doc)
        _dt2.__exit__(None, None, None)

        pending2 = []
        with debug_time("phrase.dispatch2"):
            for Sb, items in surv.items():
                if not items:
                    continue
                self._count_plan(
                    "wand_p2", sum(len(p["ids"]) for _, _, _, p in items)
                )
                pending2.extend(launch(
                    items, tb_qw[Sb], Sb, th_table(tb_qw[Sb], items, th),
                ))
        with debug_time("phrase.collect2", n=len(pending2)):
            self._collect_flat(pending2, per_query)

        # the plan's per-item arrays are freed here, under a span, and not
        # after the return, where no span would hold the time they take (a
        # large local left out of this list frees after the return, outside
        # every span but the batch's root)
        with debug_time("phrase.release"):
            phrase_plans = anchor_calls = batched = pending_rows = None
            groups = g = surv = remainder = items = tb_qw = None
            pending1 = pending2 = None
        return _hits_of(per_query, k)

    # ------------------------------------------------------------------
    # routing

    def search_batch(self, queries: list, k: int):
        """Batched top-k search, routed as the reference routes it in
        Pallas mode on the fused route (`fused=True`). Term, boosted-term
        and boolean(term) queries (and dismax over terms with tie_breaker
        0, and single-term phrase-prefixes, both expanded into term
        sub-queries) run the fused boolean path; slop-0 phrases and
        multi-term phrase-prefixes run the fused phrase path. Expansion
        sub-query results merge by dedup-keep-max. Every other query runs
        on the host engine; the phrase-family ones among them count in
        `host_routed`. The per-segment route (`fused=False`, and packed
        mode) routes as `_search_batch_segment` says.
        Returns list[list[(score, DocAddress)]].

        Traced as span `batch.search`, which holds every other span the
        batch records."""
        with debug_time("batch.search"):
            if not self.fused:
                return self._search_batch_segment(queries, k)
            return self._search_batch_fused(queries, k)

    def _search_batch_fused(self, queries: list, k: int):
        """`search_batch` on the fused route."""
        from ..collector import TopDocs
        from ..query import (
            BooleanQuery,
            DisjunctionMaxQuery,
            PhrasePrefixQuery,
            PhraseQuery,
        )

        n_orig = len(queries)
        results: list = [None] * n_orig
        _dtr = debug_time("batch.route")
        _dtr.__enter__()
        queries = list(queries)

        # expansions: sub-queries appended to the batch. Exact for
        # phrase-prefix (the host merges expansions max-per-doc) and for
        # dismax with tie_breaker 0 (score = max over clause scores, so the
        # union-max of per-clause top-k lists is the exact top-k)
        sub_of: dict[int, list[int]] = {}
        for i in range(n_orig):
            q = queries[i]
            subs = None
            if isinstance(q, PhrasePrefixQuery):
                if self._prefix_device_eligible(q):
                    continue  # rides the fused phrase launch directly
                subs = self._expand_phrase_prefix(q)
                if subs is None:
                    self._count_fallback("phrase_prefix_trunc")
                    continue
            elif (
                isinstance(q, DisjunctionMaxQuery)
                and q.tie_breaker == 0.0
                and q.queries
                and all(self._term_clause(c) is not None for c in q.queries)
            ):
                subs = q.queries
            if subs is None:
                continue
            sub_of[i] = list(range(len(queries), len(queries) + len(subs)))
            queries.extend(subs)

        bool_ids, phrase_ids = [], []
        for i, q in enumerate(queries):
            if self._term_clause(q) is not None:
                # single-SHOULD boolean == term query (identical scores and
                # tie-breaks); top-level boosted terms fold like clauses
                queries[i] = BooleanQuery.union([q])
                bool_ids.append(i)
            elif self._bool_device_eligible(q):
                bool_ids.append(i)
            elif (self._phrase_device_eligible(q)
                  or self._prefix_device_eligible(q)):
                phrase_ids.append(i)
        _dtr.__exit__(None, None, None)
        done = dict(zip(
            bool_ids,
            self._search_boolean_fused([queries[i] for i in bool_ids], k),
        ))
        done.update(zip(
            phrase_ids,
            self._search_phrase_fused([queries[i] for i in phrase_ids], k),
        ))

        def answer(i):
            if i in done:
                return done[i]
            if isinstance(queries[i], (PhraseQuery, PhrasePrefixQuery)):
                with self._stats_lock:
                    self.host_routed += 1
            with debug_time("host.search"):
                return self.searcher.search(queries[i], TopDocs(k))

        with debug_time("batch.hits"):
            for i in range(n_orig):
                if i in sub_of:
                    hits = [h for j in sub_of[i] for h in answer(j)]
                    _dedup_hits(hits)
                    results[i] = hits[:k]
                else:
                    results[i] = answer(i)
        return results

    def _search_batch_segment(self, queries: list, k: int):
        """`search_batch` on the per-segment route, as the reference routes
        it with its fused chain off (`tantivy_tpu/parallel/__init__.py:1589`,
        Pallas mode off): plain `TermQuery`s run `search_term_batch` (K7;
        K5 in packed mode), boolean(term) queries on one field the
        per-segment boolean path (K3, K4) and slop-0 phrases the
        per-segment phrase path (K6); nothing is expanded, and every other
        query (boosted terms, booleans over several fields, dismax,
        phrase-prefixes, sloppy phrases, ...) runs on the host engine, the
        phrase-family ones counted in `host_routed`. In packed mode a batch
        holding a boolean or a phrase of the device paths raises, since
        their scorers are dense-only."""
        from ..collector import TopDocs
        from ..query import PhrasePrefixQuery, PhraseQuery, TermQuery

        bool_ids, phrase_ids = [], []
        with debug_time("batch.route"):
            for i, q in enumerate(queries):
                if (self._bool_device_eligible(q)
                        and len(self._clause_fields(q)) == 1):
                    if self.mode == "packed":
                        raise dense_only("a boolean(term) query")
                    bool_ids.append(i)
                elif self._phrase_device_eligible(q):
                    if self.mode == "packed":
                        raise dense_only("a slop-0 phrase query")
                    phrase_ids.append(i)
            term_ids = [i for i, q in enumerate(queries)
                        if isinstance(q, TermQuery)]
        results: list = [None] * len(queries)

        def put(ids, answers):
            for i, hits in zip(ids, answers):
                results[i] = hits

        if term_ids:
            put(term_ids, self.search_term_batch(
                [queries[i].term for i in term_ids], k))
        if bool_ids:
            put(bool_ids, self.search_boolean_batch(
                [queries[i] for i in bool_ids], k))
        if phrase_ids:
            put(phrase_ids, self.search_phrase_batch(
                [queries[i] for i in phrase_ids], k))
        with debug_time("batch.hits"):
            for i, q in enumerate(queries):
                if results[i] is None:
                    if isinstance(q, (PhraseQuery, PhrasePrefixQuery)):
                        with self._stats_lock:
                            self.host_routed += 1
                    with debug_time("host.search"):
                        results[i] = self.searcher.search(q, TopDocs(k))
        return results

    def _worker_streams(self, n: int) -> list:
        """`n` CUDA streams on the executor's device, made once and reused
        (the fused store notes each stream that reads it)."""
        while len(self._streams) < n:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[:n]

    def search_batches(self, batches: list, k: int, pipeline: int = 3):
        """Pipelined execution of consecutive query batches: up to
        `pipeline` batches in flight on worker threads, so one batch's host
        work (numpy planning, which releases the GIL on large ops, and
        result copies, which block outside the GIL) overlaps another
        batch's device work.

        Where the reference leaves one device stream to serialise the
        launches, here each batch in flight on CUDA runs `search_batch` on a
        stream of its own (`torch.cuda.stream`), synchronised before the
        batch's results are returned; on the CPU, or with one batch in
        flight, no stream is made. The batches share the fused store, which
        any of them may grow (see `ops/fused_store.py`).

        Per-batch worker spans (seconds, processing start -> finish, so
        queue wait is excluded) land in `self.batch_spans`. Results are
        returned one list per batch, in submission order."""
        import concurrent.futures as cf
        import queue
        import time as _time

        if not batches:
            self.batch_spans = []
            return []
        results: list = [None] * len(batches)
        spans = [0.0] * len(batches)
        workers = 1 if pipeline <= 1 else min(pipeline, len(batches))
        free = queue.SimpleQueue()
        for stream in (self._worker_streams(workers)
                       if workers > 1 and self.device.type == "cuda"
                       else [None] * workers):
            free.put(stream)

        def run(i: int):
            stream = free.get()
            try:
                t0 = _time.monotonic()
                if stream is None:
                    results[i] = self.search_batch(batches[i], k)
                else:
                    with torch.cuda.stream(stream):
                        results[i] = self.search_batch(batches[i], k)
                    stream.synchronize()
                spans[i] = _time.monotonic() - t0
            finally:
                free.put(stream)

        if workers == 1:
            for i in range(len(batches)):
                run(i)
        else:
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(run, range(len(batches))))
        self.batch_spans = spans
        return results

    def prewarm(self, queries_hint: list, k: int = 10, concurrency: int = 8,
                levels=(0, 1, 2)):
        """Prepare what batches shaped like `queries_hint` need before the
        first one arrives: the fused slabs of the hint's fields on every
        segment, the position store when the hint holds phrases (on the
        per-segment route with its per-row offsets), and, on CUDA, the
        kernel libraries of the route (`_ROUTE_KERNELS`, `ops/_build.load`,
        up to `concurrency` nvcc builds at once), so the first batch pays
        neither uploads nor builds. In packed mode: the hint's fields'
        packed mirrors instead of slabs, and no position store.

        The reference compiles a grid of Mosaic kernel shapes here (`k` and
        `levels` size that grid). The port's kernels take every shape from
        one build, so no shape is compiled: this returns 0, the number of
        shapes warmed, and keeps the reference's signature."""
        import concurrent.futures as cf

        from ..ops import _build
        from ..query import BooleanQuery, PhrasePrefixQuery, PhraseQuery

        fields = set()
        phrases = False
        for q in queries_hint:
            tb = self._term_clause(q)
            if tb is not None:
                fields.add(tb[0].term.field)
            elif isinstance(q, BooleanQuery):
                fields.update(
                    tb[0].term.field
                    for tb in (self._term_clause(s) for _, s in q.clauses)
                    if tb is not None
                )
            elif isinstance(q, (PhraseQuery, PhrasePrefixQuery)):
                fields.add(q.field)
                phrases = True
        for seg_ord in range(len(self.searcher.segment_readers())):
            for f in sorted(fields):
                if self.mode == "packed":
                    self._flat_scorer(seg_ord, f)
                else:
                    self._ensure_fused_slab(seg_ord, f)
        if self.mode == "dense":
            self._warm_store(phrases)
        if self.device.type == "cuda":
            kernels = _ROUTE_KERNELS[self.mode, self.fused]
            with cf.ThreadPoolExecutor(
                    max_workers=max(1, min(concurrency, len(kernels)))
            ) as pool:
                list(pool.map(_build.load, kernels))
        return 0

    # ------------------------------------------------------------------
    # batched aggregation (shares the per-segment doc pass across requests)

    def agg_batch(self, requests: list[dict], query=None) -> list[dict]:
        """Execute N aggregation requests over one query's doc set,
        evaluating the query ONCE per segment and sharing the candidate
        docs (and the per-reader cached column factorizations) across all
        requests — the reference runs one `AggregationCollector` per
        request, re-driving the query each time (`collector.rs:23`)."""
        from ..aggregation import (
            AggregationCollector,
            collect_segment_aggs,
        )
        from ..collector import _alive_filter
        from ..query import AllQuery

        if not requests:
            return []
        cols = [AggregationCollector(r) for r in requests]
        query = query or AllQuery()
        scoring = any(c.requires_scoring() for c in cols)
        weight = query.weight(self.searcher, scoring=scoring)
        fruits: list[list] = [[] for _ in requests]
        for seg_ord, reader in enumerate(self.searcher.segment_readers()):
            res = weight.execute(reader)
            docs, scores = _alive_filter(res, reader)
            if not scoring:
                scores = None
            for ci, c in enumerate(cols):
                fruits[ci].append(
                    collect_segment_aggs(
                        c.aggs, reader, seg_ord, docs, scores, c.limits
                    )
                )
        return [c.merge_fruits(f) for c, f in zip(cols, fruits)]

    # ------------------------------------------------------------------
    # batched counting (the reference's Count collector, batched)

    def _sorted_column(self, seg_ord: int, field: str):
        cache = getattr(self, "_sorted_col_cache", None)
        if cache is None:
            cache = self._sorted_col_cache = {}
        key = (seg_ord, field)
        sv = cache.get(key)
        if sv is None:
            col = self.searcher.segment_readers()[seg_ord].fast_fields() \
                .column(field)
            sv = cache[key] = np.sort(col.values)
        return sv

    def count_batch(self, queries: list) -> list[int]:
        """Batched Count collection. Fast-field range queries over FULL
        columns in delete-free segments collapse to two `searchsorted`
        probes on a cached sorted copy of the column — O(log n) per
        (query, segment) instead of the reference's per-query column scan
        (`range_query_fastfield.rs`, `fast_field_range_doc_set.rs:43`).
        Everything else (deletes, optional/multi columns, non-range
        queries) takes the host Count path."""
        from ..collector import Count
        from ..fastfield import CARD_FULL
        from ..query.range_query import FastFieldRangeWeight, RangeQuery

        out = [0] * len(queries)
        readers = self.searcher.segment_readers()
        other = []
        for i, q in enumerate(queries):
            if not isinstance(q, RangeQuery):
                other.append(i)
                continue
            w = q.weight(self.searcher, False)
            if not isinstance(w, FastFieldRangeWeight):
                other.append(i)
                continue
            lo, hi = w._bounds_u64()
            total = 0
            fast_ok = True
            for seg_ord, reader in enumerate(readers):
                if reader.alive_bitset() is not None:
                    fast_ok = False
                    break
                col = reader.fast_fields().column(q.field)
                if col is None:
                    continue
                if col.cardinality != CARD_FULL:
                    fast_ok = False
                    break
                if lo > hi:
                    continue
                sv = self._sorted_column(seg_ord, q.field)
                total += int(
                    np.searchsorted(sv, np.uint64(hi), side="right")
                    - np.searchsorted(sv, np.uint64(lo), side="left")
                )
            if fast_ok:
                out[i] = total
            else:
                other.append(i)
        for i in other:
            out[i] = self.searcher.search(queries[i], Count())
        return out

    def _collect_flat(self, pending, per_query):
        """Append device results as per-query hit CHUNKS (score/seg/doc
        arrays); `_chunk_hits` sorts, dedups and truncates them at finalize
        time. Each result is a fused packed [3, Q, k] tensor (the segment
        rides the payload) or a per-segment (seg_ord, packed [2, Q, k])
        pair."""
        from ..ops.probe_scorer import unpack_results, unpack_results_seg

        for item in pending:
            seg_ord, packed = item if isinstance(item, tuple) else (None, item)
            packed = packed.cpu().numpy()
            if seg_ord is None:
                vals, docs, segs = unpack_results_seg(packed)
            else:
                vals, docs = unpack_results(packed)
            qs, js = np.nonzero(vals > NEG_INF)  # qs ascending (row-major)
            if not len(qs):
                continue
            vsel = vals[qs, js].astype(np.float32, copy=False)
            dsel = docs[qs, js].astype(np.uint32, copy=False)
            if seg_ord is None:
                ssel = segs[qs, js].astype(np.int32, copy=False)
            else:
                ssel = np.full(len(qs), seg_ord, dtype=np.int32)
            uq = np.unique(qs)
            bounds = np.searchsorted(qs, uq)
            bounds = np.append(bounds, len(qs))
            for i, qi in enumerate(uq.tolist()):
                lo, hi = bounds[i], bounds[i + 1]
                per_query[qi].append(
                    (vsel[lo:hi], ssel[lo:hi], dsel[lo:hi])
                )
