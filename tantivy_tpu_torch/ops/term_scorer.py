"""Batched term-query top-k over one segment's gathered blocks.

Counterpart of `tantivy_tpu/ops/term_scorer.py`, whose `_topk_kernel` is
an XLA program (`jax.jit`): a batch of Q term queries, each with B
gathered 128-doc blocks, becomes fieldnorm gather -> BM25 -> `lax.top_k`
over the query's B * 128 lanes. Here the row stage is kernel K7's cache
form (`ops/dense_flat.py`, `csrc/dense_flat.cu`; its twin on the CPU):
each of the Q * B rows gives its top-kk lanes, kk = min(k, 128), -inf
lanes included with their own docs. A per-query merge of the B * kk
candidates then sorts on one int64 key, the order-keeping score image and
then the flat index b * 128 + lane ascending: `lax.top_k`'s tie rule, so
ties across rows go to the lower flat index, not the lower doc. Scores are
f32 with the reference's op sequence (`weight * (tf / (tf + cache[norm]))`),
so results match it bit for bit, the -inf slots of a query with fewer than
k live docs included (their docs are whatever those lanes hold: dead docs,
TERMINATED padding, docs of invalid blocks).
"""

from __future__ import annotations

import torch

from .dense_flat import dense_flat_cache
from .probe_scorer import _sortable_desc


def _topk_kernel(docs, tfs, valid, norm_ids, weights, caches, alive, k: int):
    """docs/tfs: [Q, B, 128] int32 (u32 bits); valid: [Q, B] bool;
    norm_ids: [max_doc] uint8; weights: [Q] f32; caches: [Q, 256] f32;
    alive: [max_doc] bool or None; all on one device.
    Returns (scores [Q, k] f32, docs [Q, k] int32 u32 bits)."""
    Q, B, lanes = docs.shape
    if not 1 <= k <= B * lanes:
        raise ValueError(f"k={k} outside 1..{B * lanes} (B={B} blocks of "
                         f"{lanes} lanes)")
    dev = docs.device
    kk = min(k, lanes)
    qids = torch.arange(Q * B, dtype=torch.int32, device=dev) // B
    row_sc, row_doc, row_lane = dense_flat_cache(
        docs.reshape(Q * B, lanes).contiguous(),
        tfs.reshape(Q * B, lanes).contiguous(),
        valid.reshape(Q * B).contiguous(), qids, norm_ids, alive, weights,
        caches, kk=kk,
    )
    flat = (torch.arange(B, device=dev)[:, None] * lanes
            + row_lane.view(Q, B, kk).long()).view(Q, B * kk)
    sc = row_sc.view(Q, B * kk)
    # the u32 image moved to a signed range, so the int64 key keeps order
    key = ((_sortable_desc(sc) - 2**31) << 32) | flat
    top = torch.sort(key, dim=1).indices[:, :k]
    return sc.gather(1, top), row_doc.view(Q, B * kk).gather(1, top)
