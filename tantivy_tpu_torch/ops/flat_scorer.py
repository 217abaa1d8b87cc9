"""Flat batched term scorer with tensorized Block-WAND pruning, in torch.

Counterpart of `tantivy_tpu/ops/flat_scorer.py`. One call scores a mixed
work list of (query, block) pairs and returns the per-query top-k, ordered
(qid asc, score desc, doc asc): TopNComputer's tie-break. The reference's
`flat_topk_kernel` is an XLA program (`jax.jit`), not a Pallas kernel; the
whole of it (BM25 over the work items' store rows and each query's top-k)
is kernel K7's store form here (`ops/dense_flat.py`, `csrc/dense_flat.cu`)
for k <= 128. Above that, K7's row stage gives each row's top-128 and the
merge tail, kernel K8, merges them (`flat_topk_rows`:
`merge_tail.topk_from_rows`).

The rows come from the executor's `FusedStore` instead of a second upload
of the postings. A cstore row holds a block's docs (columns 0:128), tfs
(128:256) and BM25 denominator `cache[norm_id]` (256:384, NaN on deleted
and padding lanes), and for a term on field f the reference's per-query
cache is `compute_tf_cache(avg_fieldnorm(f))`, exactly the slab's cache, so
the scores keep the reference's bits. Block `b` of a (segment, field) slab
is store row `slab["offset"] + b`.

In packed mode the rows come from each (segment, field)'s packed mirror
instead (`PackedFlatScorer`, `dispatch_packed_flat`): kernel K5
(`ops/packed_flat.py`) decodes the bit-packed blocks and scores them with
the per-query denominator tables, one launch per (segment, field) chunk,
as the reference dispatches per scorer.

Block-max pruning is host numpy, as in the reference: each block's stored
`(fieldnorm_id, tf)` pair upper-bounds its score under the query's weight,
phase 1 scores each query's best-bmax blocks to set a threshold, phase 2
scores only the survivors (`BatchExecutor.search_term_batch`).
"""

from __future__ import annotations

import numpy as np
import torch

from .dense_flat import MAX_K, dense_flat_rows_store, dense_flat_store
from .merge_tail import topk_from_rows
from .packed_flat import packed_flat_topk

#: work items per launch (the CPU twin gathers [W, 384] rows: 50 MB at
#: this size)
CHUNK = 32768


def flat_topk(cstore, rows, qid, weights, k: int, num_queries: int):
    """Per-query top-k over work items: `rows` [W] int64 store rows, `qid`
    [W] int32 query of each item (any order), `weights` [Q] f32 BM25 weight
    per query, all on `cstore`'s device. Returns the packed [2, Q, k] int32
    form of `probe_scorer.pack_results` (score bits | doc), ordered (score
    desc, doc asc), -inf / 0 past a query's hits. For k <= `MAX_K` kernel
    K7's store form computes it whole (its twin on the CPU); above, the row
    stage and the merge tail (`flat_topk_rows`)."""
    return _flat_topk(cstore, rows, qid, weights, k, num_queries)[0]


def _flat_topk(cstore, rows, qid, weights, k: int, num_queries: int,
               rec: dict | None = None):
    """`flat_topk` and the route it took: "topk" (K7 whole) or "rows" (the
    row stage and the merge tail, which takes `rec`)."""
    if k <= MAX_K:
        return dense_flat_store(cstore, rows, qid, weights, k=k,
                                num_queries=num_queries), "topk"
    return flat_topk_rows(cstore, rows, qid, weights, k, num_queries,
                          rec=rec), "rows"


def flat_topk_rows(cstore, rows, qid, weights, k: int, num_queries: int,
                   rec: dict | None = None):
    """`flat_topk` through K7's row stage (each row's top-kk, kk =
    min(k, 128): a query's top-k lies in the union of its rows' top-kk)
    and the merge tail (kernel K8, `merge_tail.topk_from_rows`); the route
    for k above `MAX_K`."""
    row_sc, row_doc = dense_flat_rows_store(cstore, rows, qid, weights,
                                            kk=min(k, MAX_K))
    return topk_from_rows(row_sc, row_doc, qid, k, num_queries, rec=rec)


class _BlockMaxPlanner:
    """Host block-max planning of one (segment, field)'s share of a term
    batch."""

    def __init__(self, dfp, max_phase1_blocks: int = 2):
        self.dfp = dfp
        self.m1 = max_phase1_blocks

    def block_max_scores(self, term_ord: int, weight: np.float32,
                         cache: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(block_ids, bmax_scores) for a term (host, vectorized)."""
        dfp = self.dfp
        s = int(dfp.term_block_start[term_ord])
        n = int(dfp.term_num_blocks[term_ord])
        ids = np.arange(s, s + n)
        tf = dfp.blk_max_tf[ids].astype(np.float32)
        norm = cache[dfp.blk_max_fnid[ids]]
        bmax = (weight * (tf / (tf + norm))).astype(np.float32)
        return ids, bmax


class FlatBatchScorer(_BlockMaxPlanner):
    """Dense mode: the flat top-k over the (segment, field)'s slab of the
    fused store."""

    def __init__(self, slab: dict, max_phase1_blocks: int = 2):
        super().__init__(slab["dfp"], max_phase1_blocks)
        self.slab = slab

    def store_rows(self, blocks: np.ndarray) -> np.ndarray:
        """Fused-store rows of this slab's blocks."""
        return self.slab["offset"] + np.asarray(blocks, dtype=np.int64)


class PackedFlatScorer(_BlockMaxPlanner):
    """Packed mode: kernel K5 over the (segment, field)'s packed mirror
    (`device_index.PackedMirror`), whose block ids are the field's own."""

    def __init__(self, dfp, mirror, max_phase1_blocks: int = 2):
        super().__init__(dfp, max_phase1_blocks)
        self.mirror = mirror


def dispatch_flat(cstore, rows: np.ndarray, qids: np.ndarray,
                  weights_pad: np.ndarray, k: int, num_queries: int,
                  log: list | None = None,
                  routes: dict | None = None) -> list:
    """`flat_topk` over (store row, qid) work items in chunks of `CHUNK`.
    Returns one packed [2, Q, k] tensor per chunk, on `cstore`'s device.
    When `log` is a list, each chunk's exact inputs are appended to it,
    tagged `kind="flat"` (on the route of k > 128 its merge tail's under
    the record's "tail"); when `routes` is a dict, each chunk adds one to
    the count of the route it took (`_flat_topk`)."""
    dev = cstore.device
    w_dev = torch.from_numpy(
        np.ascontiguousarray(weights_pad, dtype=np.float32)
    ).to(dev)
    outs = []
    for lo in range(0, len(rows), CHUNK):
        args = (
            cstore,
            torch.from_numpy(rows[lo:lo + CHUNK].astype(np.int64)).to(dev),
            torch.from_numpy(qids[lo:lo + CHUNK].astype(np.int32)).to(dev),
            w_dev, k, num_queries,
        )
        rec = None
        if log is not None:
            rec = dict(kind="flat", args=args)
            log.append(rec)
        out, route = _flat_topk(*args, rec=rec)
        outs.append(out)
        if routes is not None:
            routes[route] = routes.get(route, 0) + 1
    return outs


def dispatch_packed_flat(mirror, blocks: np.ndarray, qids: np.ndarray,
                         weights, caches, k: int, num_queries: int,
                         log: list | None = None) -> list:
    """`packed_flat.packed_flat_topk` over (block, qid) work items of one
    (segment, field) in chunks of `CHUNK`; `weights` [Q + 1] and `caches`
    [Q + 1, 256] are f32 tensors on the mirror's device. Returns one packed
    [2, Q, k] tensor per chunk. When `log` is a list, each chunk's exact
    inputs are appended to it, tagged `kind="packed_flat"` (its merge
    tail's under the record's "tail")."""
    dev = mirror.blk_tab.device
    outs = []
    for lo in range(0, len(blocks), CHUNK):
        args = (
            mirror,
            torch.from_numpy(blocks[lo:lo + CHUNK].astype(np.int32)).to(dev),
            torch.from_numpy(qids[lo:lo + CHUNK].astype(np.int32)).to(dev),
            weights, caches, k, num_queries,
        )
        rec = None
        if log is not None:
            rec = dict(kind="packed_flat", args=args)
            log.append(rec)
        outs.append(packed_flat_topk(*args, rec=rec))
    return outs
