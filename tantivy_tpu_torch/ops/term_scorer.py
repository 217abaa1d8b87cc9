"""Batched term-query top-k over one segment's gathered blocks.

Counterpart of `tantivy_tpu/ops/term_scorer.py`, whose `_topk_kernel` is
an XLA program (`jax.jit`): a batch of Q term queries, each with B
gathered 128-doc blocks, becomes fieldnorm gather -> BM25 -> `lax.top_k`
over the query's B * 128 lanes. Here, for k <= 128, the whole of it is
kernel K7's cache form (`ops/dense_flat.py`, `csrc/dense_flat.cu`; its
twin on the CPU) over the Q * B rows, item q * B + b of query q: each
query's top-k ordered by score, then the flat index b * 128 + lane
ascending, `lax.top_k`'s tie rule, so ties across rows go to the lower
flat index, not the lower doc. For larger k, K7's row stage gives each
row's top-128 lanes, -inf lanes included with their own docs, and
`dense_flat.cache_merge` merges them on the same key. Scores are f32 with
the reference's op sequence (`weight * (tf / (tf + cache[norm]))`), so
results match it bit for bit, the -inf slots of a query with fewer than k
live docs included (their docs are whatever those lanes hold: dead docs,
TERMINATED padding, docs of invalid blocks).
"""

from __future__ import annotations

import torch

from .dense_flat import (
    MAX_K,
    cache_merge,
    dense_flat_cache,
    dense_flat_rows_cache,
)


def _topk_kernel(docs, tfs, valid, norm_ids, weights, caches, alive, k: int):
    """docs/tfs: [Q, B, 128] int32 (u32 bits); valid: [Q, B] bool;
    norm_ids: [max_doc] uint8; weights: [Q] f32; caches: [Q, 256] f32;
    alive: [max_doc] bool or None; all on one device.
    Returns (scores [Q, k] f32, docs [Q, k] int32 u32 bits)."""
    Q, B, lanes = docs.shape
    if not 1 <= k <= B * lanes:
        raise ValueError(f"k={k} outside 1..{B * lanes} (B={B} blocks of "
                         f"{lanes} lanes)")
    qids = torch.arange(Q * B, dtype=torch.int32, device=docs.device) // B
    args = (docs.reshape(Q * B, lanes).contiguous(),
            tfs.reshape(Q * B, lanes).contiguous(),
            valid.reshape(Q * B).contiguous(), qids, norm_ids, alive, weights,
            caches)
    if k <= MAX_K:
        return dense_flat_cache(*args, k=k, num_queries=Q)
    rows = dense_flat_rows_cache(*args, kk=MAX_K)
    return cache_merge(*rows, qids, k, Q)
