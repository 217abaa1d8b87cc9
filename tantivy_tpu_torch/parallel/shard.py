"""Segment-sharded search over several devices.

Counterpart of `tantivy_tpu/parallel/shard.py`, the reference's per-segment
fan-out and `merge_fruits` reduce (`core/executor.rs:32-102`,
`collector/mod.rs:167`) over a list of torch devices instead of a JAX mesh:

* segments are split CONTIGUOUSLY across the devices, so ascending (shard,
  local DocAddress) order is ascending global DocAddress order (the
  tie-break key);
* each shard runs the same batched engine as the single-device path: a
  `BatchExecutor` on its own device over a shard-view `Searcher` that keeps
  GLOBAL corpus statistics, so BM25 weights match the single executor's
  bit for bit;
* only the per-shard top-k candidates cross devices: the [D, Q, k]
  scores and global addresses are gathered on the first device and sorted
  once per query by (score desc, global segment asc, doc asc), the
  reference's tie-break (`sort_key_top_collector.rs:76-97`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.probe_scorer import _lexsort2, _sortable_desc
from ..searcher import DocAddress, Searcher
from . import BatchExecutor, _device

NEG_INF = np.float32(-np.inf)


class _ShardView(Searcher):
    """Searcher over ONE shard's segment readers with GLOBAL statistics.

    `doc_freq` / `num_docs` / `max_docs` / `total_num_tokens` (and hence
    `field_statistics` / `term_statistics`) delegate to the full searcher:
    BM25 idf and average fieldnorm are corpus-wide quantities, and the
    sharded engine must produce bit-identical scores to the single-chip
    engine (reference bm25.rs computes them from the whole index too)."""

    def __init__(self, global_searcher: Searcher, readers: list):
        super().__init__(global_searcher.index, readers)
        self._global = global_searcher

    def doc_freq(self, term) -> int:
        return self._global.doc_freq(term)

    def num_docs(self) -> int:
        return self._global.num_docs()

    def max_docs(self) -> int:
        return self._global.max_docs()

    def total_num_tokens(self, field: str) -> int:
        return self._global.total_num_tokens(field)


class ShardedSearcher:
    """Search over an index whose segments are split across `devices`: the
    single-device batched engine per shard (every query `BatchExecutor`
    answers) and one merge of the per-shard top-k on the first device.
    Shards run one after another. `fused` is every shard executor's route
    (`BatchExecutor`'s)."""

    def __init__(self, searcher: Searcher, devices: list,
                 fused: bool | None = None):
        self.searcher = searcher
        self.devices = [_device(d) for d in devices]
        self.n_shards = len(self.devices)
        if not self.n_shards:
            raise ValueError("no devices to shard over")
        #: shipped-block accounting of the last batch (pruning visibility):
        #: candidates >= phase1 + phase2 always (phase 2 only ships
        #: phase-1 leftovers that survive the threshold)
        self.last_shipped: dict[str, int] = {}
        readers = searcher.segment_readers()
        D = self.n_shards
        chunk = -(-len(readers) // D) if readers else 1
        self._shard_base: list[int] = []
        self._execs: list[BatchExecutor | None] = []
        for s in range(D):
            rs = readers[s * chunk: (s + 1) * chunk]
            self._shard_base.append(min(s * chunk, len(readers)))
            self._execs.append(
                BatchExecutor(_ShardView(searcher, rs),
                              device=self.devices[s], fused=fused)
                if rs else None
            )

    # -- batched search over the shards ------------------------------------

    def search_batch(self, queries: list, k: int):
        """Batched top-k over the shards for ANY query mix (each shard's
        executor routes it as `BatchExecutor.search_batch` does). Returns
        list[list[(score, DocAddress)]] with global segment ordinals."""
        Q = len(queries)
        if Q == 0:
            return []
        counters = ("wand_candidates", "wand_p1", "wand_p2")
        before = [
            {c: ex.plan_stats.get(c, 0) for c in counters} if ex else None
            for ex in self._execs
        ]
        per_shard = [
            ex.search_batch(queries, k) if ex is not None
            else [[] for _ in range(Q)]
            for ex in self._execs
        ]
        shipped = {"candidates": 0, "phase1": 0, "phase2": 0}
        for ex, b in zip(self._execs, before):
            if ex is None:
                continue
            st = ex.plan_stats
            shipped["candidates"] += st.get("wand_candidates", 0) - \
                b["wand_candidates"]
            shipped["phase1"] += st.get("wand_p1", 0) - b["wand_p1"]
            shipped["phase2"] += st.get("wand_p2", 0) - b["wand_p2"]
        self.last_shipped = shipped
        return self._fruit_merge(per_shard, Q, k)

    def search_term_batch(self, terms: list, k: int):
        from ..query import TermQuery

        return self.search_batch([TermQuery(t) for t in terms], k)

    def search_boolean_batch(self, queries: list, k: int):
        return self.search_batch(list(queries), k)

    def search_phrase_batch(self, queries: list, k: int):
        return self.search_batch(list(queries), k)

    # -- the fruit merge ---------------------------------------------------

    def _fruit_merge(self, per_shard: list, Q: int, k: int):
        """Per-shard hit lists -> the global top-k per query: the [D, Q, k]
        candidates (score, global segment, doc; -inf fill) on the first
        device, one sort per query by (score desc, segment asc, doc asc)."""
        D = self.n_shards
        scores = np.full((D, Q, k), NEG_INF, dtype=np.float32)
        segs = np.zeros((D, Q, k), dtype=np.int64)
        docs = np.zeros((D, Q, k), dtype=np.int64)
        for s, res in enumerate(per_shard):
            base = self._shard_base[s]
            for qi, hits in enumerate(res):
                hits = hits[:k]
                if not hits:
                    continue
                n = len(hits)
                scores[s, qi, :n] = [sc for sc, _ in hits]
                segs[s, qi, :n] = [base + a.segment_ord for _, a in hits]
                docs[s, qi, :n] = [a.doc_id for _, a in hits]
        msc, msg, mdc = merge_candidates(scores, segs, docs, k,
                                         self.devices[0])
        out = []
        for qi in range(Q):
            n = int(np.count_nonzero(msc[qi] != NEG_INF))
            out.append([
                (np.float32(msc[qi, j]),
                 DocAddress(int(msg[qi, j]), int(mdc[qi, j])))
                for j in range(n)
            ])
        return out


def merge_candidates(scores: np.ndarray, segs: np.ndarray, docs: np.ndarray,
                     k: int, device):
    """[D, Q, k] per-shard candidates (f32 scores with -inf fill, global
    segment ords, doc ids) -> the [Q, k] top per query on `device`, ordered
    (score desc, segment asc, doc asc), with -inf last. Returns numpy
    (scores, segs, docs)."""
    D, Q, kk = scores.shape
    dev = torch.device(device)
    sc = torch.from_numpy(
        np.ascontiguousarray(scores.transpose(1, 0, 2).reshape(-1))
    ).to(dev)
    sg = torch.from_numpy(
        np.ascontiguousarray(segs.transpose(1, 0, 2).reshape(-1))
    ).to(dev)
    dc = torch.from_numpy(
        np.ascontiguousarray(docs.transpose(1, 0, 2).reshape(-1))
    ).to(dev)
    qid = torch.arange(Q, device=dev).repeat_interleave(D * kk)
    # +0.0 folds -0.0 onto +0.0, so such ties break by address as the host
    # engine's numeric compare does
    p = _lexsort2((qid << 32) | _sortable_desc(sc + 0.0), (sg << 32) | dc)
    top = p.view(Q, D * kk)[:, :k]
    return (sc[top].cpu().numpy(), sg[top].cpu().numpy(),
            dc[top].cpu().numpy())


def default_devices(n: int | None = None) -> list:
    """`cuda:0` ... `cuda:{count-1}` (the first `n` of them); raises when
    CUDA is absent: sharded search never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no devices to shard over")
    devs = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    return devs if n is None else devs[:n]
