"""Entry points of the port: one forward step on the term-scoring
path, and a sharded search over several devices checked against the host
engine.

Counterpart of the reference's `__graft_entry__.py`. `entry()` returns the
same forward (`ops/term_scorer._topk_kernel`: BM25 + top-k over one
segment's gathered blocks, kernel K7 on the card) and the same example
arguments, built the same way over the same tiny index, as torch tensors on
`device`. `dryrun_multichip(n)` runs the reference's dry run (term, boolean
and phrase batches through `ShardedSearcher` over n shards, each checked
against the host engine) over torch devices; it needs no subprocess, since
the port holds no backend state a caller could have set.
"""

from __future__ import annotations

import numpy as np
import torch


def _build_tiny_index(num_docs=256, vocab=24, num_commits=1, seed=11):
    import tantivy_tpu_torch as tt

    rng = np.random.default_rng(seed)
    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    schema = b.build()
    index = tt.Index.create_in_ram(schema)
    w = index.writer_for_tests()
    words = [f"w{i}" for i in range(vocab)]
    per = num_docs // num_commits
    for _ in range(num_commits):
        for _ in range(per):
            n = int(rng.integers(1, 20))
            w.add_document(tt.Document(body=" ".join(rng.choice(words, n))))
        w.commit()
    w.close()
    return index, words


def entry(device="cuda"):
    """(forward, example_args): the batched term-query BM25 + top-k step
    over one segment's blocks, k = 10, Q = 8 queries of B = 4 blocks.
    `forward(*example_args)` returns (scores [8, 10] f32, docs [8, 10]
    int32, u32 bits). The tensors live on `device`, which defaults to the
    current card and must exist: nothing moves to the CPU unless asked."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.ops.device_index import DeviceSegment
    from tantivy_tpu_torch.ops.term_scorer import _topk_kernel
    from tantivy_tpu_torch.parallel import _device
    from tantivy_tpu_torch.query.bm25 import Bm25Weight

    dev = _device(device)
    index, words = _build_tiny_index()
    searcher = index.reader().searcher()
    reader = searcher.segment_readers()[0]
    dseg = DeviceSegment(reader, mode="dense")
    dfp = dseg.field_postings("body")

    k = 10
    Q, B = 8, 4
    terms = [tt.Term.from_field_text("body", w) for w in words[:Q]]
    fs = searcher.field_statistics("body")
    weights = np.zeros(Q, dtype=np.float32)
    caches = np.zeros((Q, 256), dtype=np.float32)
    block_ids = np.zeros((Q, B), dtype=np.int64)
    valid = np.zeros((Q, B), dtype=bool)
    inv = reader.inverted_index("body")
    for qi, t in enumerate(terms):
        bm = Bm25Weight.for_one_term(
            max(searcher.doc_freq(t), 1), fs.total_num_docs,
            fs.average_fieldnorm,
        )
        weights[qi] = bm.weight
        caches[qi] = bm.cache
        o = inv.term_ord(t.value_bytes)
        if o is not None:
            s0 = int(dfp.term_block_start[o])
            n = min(int(dfp.term_num_blocks[o]), B)
            block_ids[qi, :n] = np.arange(s0, s0 + n)
            valid[qi, :n] = True

    docs, tfs = dfp.gather_blocks(block_ids.reshape(-1))
    alive = np.ones(reader.max_doc, dtype=bool)

    def forward(docs, tfs, valid, norm_ids, weights, caches, alive):
        return _topk_kernel(docs, tfs, valid, norm_ids, weights, caches,
                            alive, k)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    example_args = (
        docs.reshape(Q, B, 128).to(dev),
        tfs.reshape(Q, B, 128).to(dev),
        on_dev(valid),
        on_dev(dfp.norm_ids_np),
        on_dev(weights),
        on_dev(caches),
        on_dev(alive),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Shard a multi-segment index over `n_devices` shards and run one term,
    one boolean and one phrase batch through `ShardedSearcher`, each hit
    list checked against the host engine (DocAddresses, order and f32
    score bits), and the shipped-block accounting of the boolean batch.

    With device="cuda" the shards go to `shard.default_devices()` in turn
    until there are `n_devices` of them (on a one-card machine all sit on
    cuda:0); any other device holds every shard. Prints the device list;
    returns it with the number of queries checked per batch. Raises on any
    difference."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.parallel.shard import (
        ShardedSearcher,
        default_devices,
    )

    if torch.device(device).type == "cuda" and torch.device(
            device).index is None:
        cards = default_devices()
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    print(f"dryrun_multichip: {n_devices} shards on "
          f"{[str(d) for d in devices]}")

    index, words = _build_tiny_index(
        num_docs=32 * n_devices, vocab=16, num_commits=n_devices
    )
    searcher = index.reader().searcher()
    sharded = ShardedSearcher(searcher, devices)

    def check(queries, results):
        if len(results) != len(queries):
            raise AssertionError(f"{len(results)} results for "
                                 f"{len(queries)} queries")
        for q, hits in zip(queries, results):
            host = searcher.search(q, tt.TopDocs(5))
            if _bits(hits) != _bits(host):
                raise AssertionError(f"sharded hits differ from the host "
                                     f"engine for {q!r}: {hits} != {host}")

    # term batch over the shards (each shard's fused chain: the group
    # probe, K1) and the fruit merge
    terms = [tt.Term.from_field_text("body", w) for w in words[:8]]
    check([tt.TermQuery(t) for t in terms],
          sharded.search_term_batch(terms, k=5))

    # boolean batch over the shards (K1 again) and the fruit merge
    def tq(w):
        return tt.TermQuery(tt.Term.from_field_text("body", w))

    bqueries = [
        tt.BooleanQuery.union([tq(words[0]), tq(words[1])]),
        tt.BooleanQuery.intersection([tq(words[2]), tq(words[3])]),
        tt.BooleanQuery([
            (tt.Occur.MUST, tq(words[4])),
            (tt.Occur.MUST_NOT, tq(words[5])),
        ]),
    ]
    check(bqueries, sharded.search_boolean_batch(bqueries, k=5))
    shipped = sharded.last_shipped
    if shipped["candidates"] < shipped["phase1"] + shipped["phase2"]:
        raise AssertionError(f"shipped more blocks than candidates: "
                             f"{shipped}")

    # phrase batch over the shards (the fused phrase chain: the position
    # probe, K2)
    pqueries = [
        tt.PhraseQuery("body", [words[i], words[j]])
        for i, j in ((0, 1), (1, 0), (2, 3))
    ]
    check(pqueries, sharded.search_phrase_batch(pqueries, k=5))
    return {"devices": [str(d) for d in devices], "term": len(terms),
            "boolean": len(bqueries), "phrase": len(pqueries)}


def _bits(hits):
    return [(int(np.float32(s).view(np.int32)), a) for s, a in hits]
