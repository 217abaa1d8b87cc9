"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--docs N] [--seed S] [--profile PATH]
                          [--baseline NAME=DIR ...]

Phases (any failure exits non-zero; nothing is caught and then passed):
1. environment: CUDA must be available; prints torch/CUDA versions and the
   card's name and power limit;
2. build: compiles the nine kernels, group-probe, phrase-probe,
   windowed-probe, packed flat-scorer, deep-probe, per-segment phrase,
   dense flat-scorer, merge-tail and the planner's UB sweep, from
   `tantivy_tpu_torch/csrc` with
   nvcc into `build/kernels/`, all at once, and prints what ptxas reports
   for each (registers, shared memory, spills) and each kernel's threads,
   shared memory per CTA and CTAs resident per SM
   (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`);
3. index: a Zipf corpus (one `body` TEXT field, windows of 20-100 tokens
   over a 30,000-word token stream built from the seed), committed in 4
   segments;
4. main path (the fused route): `BatchExecutor(searcher,
   device="cuda").search_batch` on 256-query term, AND and OR batches, on
   a batch of 3-4 clause queries,
   on bigram phrases and two-term phrase-prefixes sampled from the token
   stream (one warm and TIMED_BATCHES timed batches each), then on one
   untimed batch of 3- and 4-term phrases from the stream, k = 10, with
   every kernel launch counter reset just before and read just after;
   prints per-suite QPS, p50 batch latency and how many (query, segment)
   plans the planner sent to the host engine, by reason; every merge tail
   of every path below runs kernel K8 (`ops/merge_tail.py`): on each path
   that keeps a launch log, K8's launches must equal the merge tails its
   kernel rounds recorded (under "tail") times its kernels a call
   (`merge_tail.KERNELS_PER_CALL`, one cooperative launch; the records'
   tail inputs move to the host after each batch, so that the log does
   not add to the peak device memory); every fused boolean round bounds
   its blocks on the card: each UB sweep (`ub_sweep.clause_details`) of
   the timed batches is recorded, one with block rows must launch the UB
   sweep kernel once and one without none, a suite's UB sweep launches
   must equal its sweeps with rows, and the AND, OR and 3-4 clause suites
   must sweep in every timed batch;
4b. segment route: `search_batch` of a second executor on the same index,
   `BatchExecutor(searcher, device="cuda", fused=False)` (the reference's
   XLA-mode routing: term queries on the flat scorer, K7; one-field
   booleans on the per-segment Block-WAND path, K3 and K4; slop-0 phrases
   on the per-segment phrase plan, K6; nothing expanded), on the term,
   AND, OR, 3-4 clause and bigram phrase logs, one warm and TIMED_BATCHES
   timed batches each, with every launch counter reset just before the
   phase and read just after; the hits of every timed batch must equal
   the main path's list for list, and per suite K7's launches must equal
   the launch log's flat chunks times its 2 kernels, K3's the planner's
   launches over its rungs, K4's `probe_deep`, K6's `phrase_seg`, K8's
   the launch log's merge tails (one launch each), with no K1, K2 or K5
   launch; prints per suite QPS and p50 beside the main
   path's, launches, `host_routed` and host plans by reason; then the
   first SEGMENT_PREFIX_QUERIES queries of the prefix log in one batch (no
   warm batch), which this route sends wholly to the host engine, with no
   launch: ms per query beside the main path's; then the peak device
   memory, both executors' fused stores on the card;
5. probe path: `search_boolean_batch` of the `fused=False` executor (the
   per-segment Block-WAND path: the windowed-probe kernel K3 and the
   deep-probe kernel K4; the fused executor's runs the fused chain) on the
   term (each query wrapped as a one-clause union), AND, OR and 3-4 clause
   logs, one warm and TIMED_BATCHES timed batches each, with every launch
   counter reset just before and read just after (K4's launches must equal
   the planner's `probe_deep` count, and K1 and K2 may not launch); prints
   per suite QPS, p50, windowed-probe launches per rung, deep-path
   launches and host plans, then the phase's peak device memory;
5b. per-segment phrase path: `search_phrase_batch` of the `fused=False`
   executor (the reference's per-segment Block-WAND phrase plan: kernel
   K6) on the
   bigram phrase log and on a log of 3- and 4-term phrases, one warm and
   TIMED_BATCHES timed batches each, with every launch counter reset just
   before and read just after (K6's launches must equal the planner's
   `phrase_seg` count, and no other kernel may launch); prints per suite
   QPS and p50 beside the main path's phrase suite (K2), K6 launches and
   host plans by reason (`phrase_seg_wide_window` among them, now 0); the
   bigram suite's hits must equal the main path's phrase suite's list for
   list; then one batch of the bigram log through `search_phrase_batch` of
   each executor: the fused executor's must run the fused chain alone
   (K2, no K6), the `fused=False` executor's the per-segment plan alone
   (K6, no K2), and both must give the main path's hits;
6. exactness: sampled queries of every suite of the four paths (the
   segment route's prefix batch, which the host engine answered, aside)
   must give the host engine's hits (DocAddresses, order and f32 score
   bits);
6a. pipelined: `executor.search_batches(..., pipeline=PIPELINE)` over the
   timed batches of every main-path suite (all of them in flight, each on
   its own CUDA stream), with the launch counters reset just before and read just after;
   the results must equal the closed-loop results list for list; prints
   both QPS figures and the p50 of `batch_spans`;
6b. term batches: `executor.search_term_batch` (the flat scorer: the
   dense flat-scorer kernel K7's store form over the fused store, each
   query's top-k on the card: a group and a select kernel a call) on the
   term log, one warm and TIMED_BATCHES timed batches, with the counters
   reset just before the timed batches and read just after (K7's launches
   must equal the `kind="flat"` chunks the launch log recorded for them
   times its 2 kernels, and no chunk may take the row stage of k > 128);
   sampled hits must equal the host engine's; every K7 chunk of one timed
   batch is replayed through the kernel and its twin (bitwise); prints
   QPS, p50, the flat scorer's device ms over one batch's calls (K7
   alone) beside the route of k > 128 on the same calls (K7's row stage
   and the torch merge tail), K7's replayed device ms (`_device_ms`) and
   the twin's ms (CUDA events);
6c. packed term batches: a packed-mode executor (`BatchExecutor(searcher,
   device="cuda", mode="packed")`: the postings stay bit-packed on the card
   and the packed flat-scorer kernel K5 decodes them per query) runs the
   term log's warm and TIMED_BATCHES timed batches through
   `search_term_batch`, with the counters reset just before and read just
   after; hits must equal the dense term batches' list for list and sampled
   hits the host engine's; every K5 chunk of one timed batch is replayed
   through the kernel and its twin (bitwise) and timed (`_device_ms`);
   prints QPS, p50, K5's launches and ms per batch, and the packed mirror's
   device bytes beside the fused store's cstore bytes;
6d. sharded: `ShardedSearcher(searcher, [cuda:0, cuda:0])` (two segments a
   shard) over the term, AND, OR and phrase logs, with the counters reset
   just before and read just after; hits must equal the single executor's;
   prints QPS and peak device memory;
6e. warmer, count and agg, on a side index of SIDE_DOCS docs with the
   bench's fast fields: a `DeviceSearchWarmer` warms a reader, `for_searcher`
   must return its executor and the first batch must answer (counters reset
   just before it); `count_batch` of BATCH range queries must equal the
   host `Count` of each, and `agg_batch` of the bench's aggregation
   requests one `AggregationCollector` each; prints the ms of each;
6f. entry points (`tantivy_tpu_torch.entry`), with the counters reset just
   before and read just after: `entry()`'s forward (the term scorer's
   `_topk_kernel`: K7's cache form, each query's top-k) on the card must
   equal, bitwise, the same forward over the same tensors on the CPU (the
   twin, `entry(device="cpu")`), and must launch K7; then
   `dryrun_multichip(4)` (term, boolean and phrase batches over four
   shards on the card's devices in turn, each against the host engine)
   must pass;
7. kernel vs twin: real launch chunks captured from both paths (group
   probe: phase 1 and phase 2 with thresholds, clause buckets 2 and 4;
   phrase probe: phase 1 and phase 2, partner buckets 1 and 3, both slab
   rungs; windowed probe: phases 1 and 2, clause buckets 2 and 4, every
   rung seen) and synthetic chunks at the largest tiers (one per kernel,
   and a second windowed-probe chunk at W = 8,192, kw = 64, T = 4) run
   through the kernel and its plain PyTorch twin on the card; scores must
   be bitwise equal and docs equal; prints both times (the kernel's device
   time from torch.profiler, the twin's between CUDA events) and the
   bound;
   then each synthetic hard case of `ops/kernel_cases.py` (1,024 tied
   survivors, 16 clauses, sub-windows of up to 255 rows, wide windows
   with lane docs in every row, windows at the store's end) at
   kk = 1, 10 and 128 through the group-probe or windowed-probe kernel and
   its twin, bitwise, each deep hard case (a region at the reference's
   search-depth edge, 16 clauses) through K4 and its twin, and each packed
   hard case (every bit width, a field without freqs, every lane tied) at
   kk = 1, 10 and 128 through K5 and its twin, and each per-segment
   phrase hard case (leader tf 16, partner tf 256, a 1,024-row window,
   positions at the postore's end, deleted docs, 8 terms, every lane tied)
   at kk = 1, 10 and 128 through K6 and its twin, and each dense hard case
   (every lane tied, dead and NaN rows, TERMINATED padding mid-row,
   invalid rows holding real docs, `alive` None, fewer live lanes than
   k) at k = 1, 10 and 128 through both forms of K7 and its twin, and at
   k = 200 through K7's row stage and the torch merge; then
   every deep chunk of
   the probe path through K4 and its twin and every K6 chunk of one timed
   batch of each per-segment phrase suite through K6 and its twin,
   bitwise, each with the largest chunk's kernel and twin ms and bound;
7b. UB sweep vs numpy: every UB sweep the main path's timed batches made
   (phase 4), and then all of them as one sweep (thousands of calls, a grid
   of several waves), through the kernel (`ub_sweep.clause_details`) and
   its twin, the numpy `batched_clause_details`: ids, UB and term bits and
   the window columns jlo, i0, i1 and widths must be equal, with the same
   MUST drops; prints per sweep the calls, block rows and pair rows, and
   for each suite's first sweep and the combined one the kernel's device
   ms (torch.profiler), the whole card path's ms (packing, upload, launch,
   copy back, cutting the dicts; host clock), numpy's ms and the bound
   (the outputs written, the packed tables and each block's first and
   last doc and `bfac` read once);
8. per batch: the real chunks one timed batch of each suite of both paths
   launched, replayed through their kernel; prints per kernel and suite
   the launches per timed batch, the kernel's device ms over the chunks
   (CUDA events around the calls enqueued behind a spin kernel,
   `_queued_ms`), the bytes they must move (K4's
   and K6's: the 32-byte sectors of the work, whatever a build loads),
   the bound
   (those bytes at the card's memory rate; the kernels do no tensor-core
   work), the share of the bound the kernel reaches and its occupancy
   (CTAs resident per SM, threads and shared memory per CTA), and for the
   merge tail (K8) the twin's device ms over the same calls (the torch
   tail every path ran before K8; torch.profiler's kernel durations, as
   the host does not get ahead of it); with
   `--baseline NAME=DIR`, every chunk (and each synthetic chunk) also runs
   through the kernels built from the sources in DIR, an earlier tree's
   `tantivy_tpu_torch/csrc`, and their ms and the chunks whose output
   differs from the current kernel's are printed beside (and the largest
   packed and deep chunks' ms through those kernels, and the largest merge
   tail's in phase 10; an earlier K8 of two kernels a call runs through
   its own C entry points);
9. with `--profile PATH` only: one more fresh batch per timed suite of
   the main path, the segment route and the probe path, of the phrase
   log through the per-segment plan, and of
   the term log through the dense and the packed executor's
   `search_term_batch`, with the engine's host spans and
   `torch.profiler` on; the
   per-layer breakdown (host span ms, device ms per kernel, idle share,
   K8's ms and the sort kernels that remain) goes to PATH as JSON;
10. merge tails: every merge-tail call of every timed batch of the main
   path (the fused route: K8's seg form), of the segment route, the probe
   path and the per-segment phrase path (the `fused=False` route: its
   rows form) and of the packed executor (rows form) through K8 and its
   twin on the card, bitwise; then each `kernel_cases.tail_case` at
   kk = 32 and 128 and k = 1, 10, 40, 128, 200, 1000 and 2000 in both
   forms; prints the calls held and the largest call's kernel and twin
   ms, bound and, with `--baseline`, its ms through the earlier K8.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record, whose `launches_by_path` gives each kernel's
launches on every path above that resets the counters (main, segment,
probe, phrase_seg, pipelined, term_batch, packed_term_batch, sharded,
warmer, entry). The script imports nothing of `tantivy_tpu` or
jax: the port stands alone.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BATCH = 256
K = 10
#: timed batches per suite (and batches the pipelined pass keeps in
#: flight): 2 keeps the whole smoke near 8 minutes at 1M docs, where the
#: phrase-prefix suite alone takes about 18 s a batch
TIMED_BATCHES = 2
EXACT_SAMPLE = 64
VOCAB = 30_000
STREAM_TOKENS = 400_000
SEGMENTS = 4
SYNTH_W = 65536
#: the phrase kernel's synthetic chunk: the widest W tier of the 24-row rung
SYNTH_W_PHRASE = 32768
#: the windowed-probe kernel's synthetic chunks: (W, kw, T) at the largest
#: W tier of the narrowest and of the widest rung
SYNTH_PROBE = ((65536, 2, 2), (8192, 64, 4))
#: the boolean suites the probe path runs
PROBE_SUITES = ("term", "and", "or", "multi")
#: the windowed-probe kernel's rungs (window rows kw)
PROBE_RUNGS = (2, 8, 64)
#: the main path's suites that the segment route (phase 4b) runs
SEGMENT_SUITES = ("term", "and", "or", "multi", "phrase")
#: the queries of the prefix log that the segment route runs, all on the
#: host engine
SEGMENT_PREFIX_QUERIES = 32
#: why the per-segment phrase plan sends a (query, segment) to the host
#: engine (`fallbacks`); the port has no wide-window reason any more, and
#: the smoke shows its count of 0
PHRASE_SEG_HOST_REASONS = ("phrase_seg_leader_tf", "phrase_seg_partner_tf",
                           "phrase_seg_wide_window")
#: device memory rate of one H100 SXM (NVIDIA's data sheet), bytes per second:
#: the kernels do no tensor-core work, so bytes bound them
HBM_BYTES_PER_S = 3.35e12
#: why no library call stands beside the kernels
NO_LIBRARY = ("no single PyTorch call computes a sorted-set probe, BM25 "
              "scoring and a per-group top-kk over these stores, nor a "
              "position intersection with them, nor a bit-unpack, "
              "strict-delta prefix sum, BM25 and per-row top-kk over packed "
              "postings, nor BM25 with each query's top-k over fused-store "
              "or dense rows grouped on the card, in (score desc, doc or flat "
              "index asc) order (torch.topk does not order ties), nor each "
              "query's top-k of a launch's per-row candidates grouped by a "
              "qid a row, in (score desc, segment, doc asc) order, with the "
              "keep-max dedup of each query's (segment, doc) addresses "
              "before the cut: torch.topk takes no groups, orders no ties "
              "and deduplicates nothing, and torch.unique does not keep a "
              "max")
#: the fused chains' merge-tail k at k = K (the planner's k_eff)
TAIL_FUSED_K = 32
#: batches in flight in the pipelined pass
PIPELINE = 3
#: the suites the sharded pass runs, and its devices (one card: two shards
#: on it, two segments each)
SHARD_SUITES = ("term", "and", "or", "phrase")
SHARD_DEVICES = ("cuda:0", "cuda:0")
#: docs of the side index with the bench's fast fields (count, agg, warmer)
SIDE_DOCS = 200_000
#: the bench's aggregation requests (`bench.py` AGG_REQUESTS)
AGG_REQUESTS = {
    "avg_u64": {"a": {"avg": {"field": "score"}}},
    "stats_f64": {"s": {"stats": {"field": "score_f64"}}},
    "percentiles_f64": {
        "p": {"percentiles": {"field": "score_f64",
                              "percents": [95, 99, 99.9]}}
    },
    "histogram": {"h": {"histogram": {"field": "score", "interval": 10.0}}},
    "terms_1000": {"t": {"terms": {"field": "score", "size": 100}}},
    "range_with_avg": {
        "r": {
            "range": {"field": "score",
                      "ranges": [{"to": 100.0},
                                 {"from": 100.0, "to": 500.0},
                                 {"from": 500.0}]},
            "aggs": {"a": {"avg": {"field": "score_f64"}}},
        }
    },
    "composite": {
        "c": {"composite": {"size": 100,
                            "sources": [{"s": {"terms": {"field": "score"}}}]}}
    },
}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def token_stream(seed: int) -> np.ndarray:
    """Zipf token stream over a VOCAB-word vocabulary (the bench's
    stand-in for the reference's wiki.json token stream)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, VOCAB + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    words = np.array([f"w{i}" for i in range(VOCAB)])
    return rng.choice(words, STREAM_TOKENS, p=probs)


def corpus(stream: np.ndarray, n_docs: int, seed: int):
    """Documents of 20-100 tokens: consecutive windows over the stream,
    with a shifting start per pass."""
    rng = np.random.default_rng(seed + 1)
    n = len(stream)
    lens = rng.integers(20, 100, n_docs)
    made = 0
    passno = 0
    while made < n_docs:
        i = (passno * 131) % max(n - 200, 1)
        while i + 10 < n and made < n_docs:
            ln = int(lens[made])
            yield " ".join(stream[i:i + ln])
            i += ln
            made += 1
        passno += 1


def zstd_codec() -> str:
    """The engine's host layers (term dictionary, doc store) compress with
    the optional `zstandard` package. Where it is missing, register an
    uncompressed stand-in: the index is built in memory and read back by
    this process only, so its bytes never need to be zstd."""
    try:
        import zstandard  # noqa: F401

        return "zstandard"
    except ImportError:
        pass
    import types

    class ZstdCompressor:
        def __init__(self, level=3):
            self.level = level

        def compress(self, data):
            return bytes(data)

    class ZstdDecompressor:
        def decompress(self, data):
            return bytes(data)

    mod = types.ModuleType("zstandard")
    mod.ZstdCompressor = ZstdCompressor
    mod.ZstdDecompressor = ZstdDecompressor
    sys.modules["zstandard"] = mod
    return "uncompressed stand-in (zstandard not installed)"


def build_index(stream, n_docs: int, seed: int):
    import tantivy_tpu_torch as tt

    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer(memory_budget=2_000_000_000, num_threads=1,
                     merge_policy=tt.NoMergePolicy())
    per = -(-n_docs // SEGMENTS)
    for i, body in enumerate(corpus(stream, n_docs, seed)):
        w.add_document(tt.Document(body=body))
        if (i + 1) % per == 0 and i + 1 < n_docs:
            w.commit()
    w.commit()
    w.close()
    return index


def query_logs(stream, seed: int, n: int) -> dict:
    """Query terms sampled by document frequency (common terms dominate,
    as in real query logs)."""
    import tantivy_tpu_torch as tt

    rng = np.random.default_rng(seed + 2)
    uniq, counts = np.unique(stream, return_counts=True)
    keep = counts >= 5
    uniq, counts = uniq[keep], counts[keep]
    probs = counts / counts.sum()

    def terms(width):
        return rng.choice(uniq, size=(n, width), p=probs)

    def t(w):
        return tt.TermQuery(tt.Term.from_field_text("body", str(w)))

    def ngrams(width):
        """`width` consecutive stream tokens (phrases that occur)."""
        at = rng.integers(0, len(stream) - width, n)
        return [[str(w) for w in stream[i:i + width]] for i in at]

    multi = []
    for i, ws in enumerate(terms(4)):
        width = 3 + i % 2
        clauses = [t(w) for w in ws[:width]]
        multi.append(tt.BooleanQuery.union(clauses) if i % 3
                     else tt.BooleanQuery.intersection(clauses[:3]))
    return {
        "term": [t(w) for (w,) in terms(1)],
        "and": [tt.BooleanQuery.intersection([t(a), t(b)])
                for a, b in terms(2)],
        "or": [tt.BooleanQuery.union([t(a), t(b)]) for a, b in terms(2)],
        "multi": multi,
        "phrase": [tt.PhraseQuery("body", p) for p in ngrams(2)],
        "prefix": [tt.PhrasePrefixQuery("body", [a, b[:3]])
                   for a, b in ngrams(2)],
    }


def long_phrases(stream, seed: int, n: int = BATCH):
    """`n` 3- and 4-term phrases from the stream (one batch by default),
    so the phrase kernel's 3-partner bucket runs too."""
    import tantivy_tpu_torch as tt

    rng = np.random.default_rng(seed + 4)
    at = rng.integers(0, len(stream) - 4, n)
    return [tt.PhraseQuery("body", [str(w) for w in stream[i:i + 3 + j % 2]])
            for j, i in enumerate(at)]


def bits(hits):
    return [(int(np.float32(s).view(np.int32)), a) for s, a in hits]


def timed_batches(search, qlog, log):
    """TIMED_BATCHES fresh batches of `qlog` after the first (the caller's
    warm batch) through `search`: (QPS, p50 ms, (query, hits) pairs, the
    launch records that the first timed batch appended to `log`)."""
    import torch

    spans, pairs, first = [], [], []
    offload_tails(log)
    for b in range(1, 1 + TIMED_BATCHES):
        batch = qlog[b * BATCH:(b + 1) * BATCH]
        n0 = len(log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = search(batch, K)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        offload_tails(log[n0:])
        pairs.extend(zip(batch, res))
        if b == 1:
            first = log[n0:]
    return (len(pairs) / sum(spans), float(np.median(spans)) * 1e3, pairs,
            first)


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name."""
    from tantivy_tpu_torch.ops import (
        bool_probe,
        deep_probe,
        dense_flat,
        group_probe,
        merge_tail,
        packed_flat,
        phrase_probe,
        phrase_scorer,
        ub_sweep,
    )

    return {"group_probe": group_probe.launches,
            "phrase_probe": phrase_probe.launches,
            "bool_probe": bool_probe.launches,
            "packed_flat": packed_flat.launches,
            "deep_probe": deep_probe.launches,
            "seg_phrase": phrase_scorer.launches,
            "dense_flat": dense_flat.launches,
            "merge_tail": merge_tail.launches,
            "ub_sweep": ub_sweep.launches}


class sweep_capture:
    """Within the block, every UB sweep of the fused boolean planner
    (`ub_sweep.clause_details`) is recorded in `sweeps` as (store, calls);
    a sweep with block rows on a CUDA store must launch the kernel once,
    any other none."""

    def __init__(self):
        self.sweeps = []

    def __enter__(self):
        from tantivy_tpu_torch.ops import ub_sweep

        self.inner = inner = ub_sweep.clause_details

        def capture(store, calls):
            n0 = ub_sweep.launches
            out = inner(store, calls)
            want = int(store.device.type == "cuda"
                       and any(c[1] for c in calls))
            if ub_sweep.launches - n0 != want:
                raise AssertionError(f"a UB sweep of {len(calls)} calls "
                                     f"launched {ub_sweep.launches - n0} "
                                     f"kernels, not {want}")
            self.sweeps.append((store, calls))
            return out

        ub_sweep.clause_details = capture
        return self

    def __exit__(self, *exc):
        from tantivy_tpu_torch.ops import ub_sweep

        ub_sweep.clause_details = self.inner


def build_kernel(name: str, src_dir: str, tag: str):
    """The kernel library built from `src_dir/<name>.cu` (with the headers
    beside it) with the port's nvcc flags into build/kernels/<tag>/, for a
    baseline run beside the current kernels; None when the directory holds
    no such source."""
    import ctypes
    import os

    from tantivy_tpu_torch.ops import _build

    src = os.path.join(src_dir, f"{name}.cu")
    if not os.path.exists(src):
        return None
    out_dir = os.path.join(_build.BUILD_DIR, tag)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    return ctypes.CDLL(out)


class kernel_lib:
    """Within the block, kernel `name`'s wrapper launches through `lib`
    (a baseline build) instead of the current build. An earlier build of
    the dense flat scorer may have its row stage alone, which the
    wrapper's strict binding refuses: within the block the wrapper gets
    `lib` with the entry points it has bound."""

    def __init__(self, name, lib):
        self.name, self.lib = name, lib

    def __enter__(self):
        from tantivy_tpu_torch.ops import _build, dense_flat, merge_tail

        self.saved = _build.load(self.name)
        _build._libs[self.name] = self.lib
        if (self.name == "merge_tail"
                and not hasattr(self.lib, "merge_tail_launch")):
            self.saved_launch = merge_tail._launch
            merge_tail._launch = two_kernel_tail(self.lib)
        if self.name == "dense_flat":
            for fn_name, (args, res) in dense_flat.signatures().items():
                fn = getattr(self.lib, fn_name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = args, res
            self.saved_bind = dense_flat._lib
            dense_flat._lib = lambda: self.lib

    def __exit__(self, *exc):
        from tantivy_tpu_torch.ops import _build, dense_flat, merge_tail

        _build._libs[self.name] = self.saved
        if hasattr(self, "saved_launch"):
            merge_tail._launch = self.saved_launch
        if self.name == "dense_flat":
            dense_flat._lib = self.saved_bind


def two_kernel_tail(lib):
    """`merge_tail._launch` for an earlier K8 build `lib` of two kernels a
    call (a group kernel of one CTA, then the select kernel), through its
    own C entry points, for a baseline run beside the current K8."""
    import ctypes

    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.merge_tail_scratch_bytes.argtypes = [i, i, i]
    lib.merge_tail_scratch_bytes.restype = ctypes.c_longlong
    lib.merge_tail_group_launch.argtypes = [p, i, i, i, p, p]
    lib.merge_tail_group_launch.restype = ctypes.c_int
    lib.merge_tail_select_launch.argtypes = [i, p, p, p, i, i, i, i, p, p,
                                             p]
    lib.merge_tail_select_launch.restype = ctypes.c_int

    def launch(seg, row_sc, row_doc, row_seg, qid, W, kk, k, num_queries,
               out, stream):
        n = lib.merge_tail_scratch_bytes(W, num_queries, k)
        scratch = torch.empty(n, dtype=torch.uint8, device=out.device)
        err = lib.merge_tail_group_launch(qid.data_ptr(), W, num_queries, k,
                                          scratch.data_ptr(), stream)
        if err == 0:
            err = lib.merge_tail_select_launch(
                1 if seg else 0, row_sc.data_ptr(), row_doc.data_ptr(),
                row_seg.data_ptr() if seg else None, W, kk, num_queries, k,
                scratch.data_ptr(), out.data_ptr(), stream)
        return err, "baseline"

    return launch


def occupancy(lib, name: str) -> dict:
    """Threads, shared memory per CTA and CTAs resident per SM of kernel
    `name` in `lib` (the phrase kernel's at 1 and 3 partners, the dense
    flat scorer's group kernel, select kernel in each form at k = K and
    row stage in each form; an earlier build's row stage alone)."""
    import ctypes

    def query(fn_name, *lead):
        vals = [ctypes.c_int(0) for _ in range(3)]
        err = getattr(lib, fn_name)(*lead, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {err}")
        return dict(zip(("threads", "smem_bytes", "ctas_per_sm"),
                        (v.value for v in vals)))

    own = f"{name}_occupancy"
    if name == "merge_tail" and not hasattr(lib, "merge_tail_launch"):
        # an earlier K8 of two kernels a call, group and select
        return {"group": query(own, 2, K), "select_rows": query(own, 0, K),
                "select_seg": query(own, 1, TAIL_FUSED_K)}
    if name == "merge_tail":
        # the grid kernel in each form: the per-segment tails at kk = k =
        # K, the fused chains' at their k_eff (TAIL_FUSED_K at k = K) and
        # at the largest calls' kk = k = 128, and above the shared-memory
        # k (sort arrays in global scratch); the small kernel of small
        # calls
        return {"rows": query(own, 0, 0, K, K),
                "seg": query(own, 1, 0, TAIL_FUSED_K, TAIL_FUSED_K),
                "seg_kk128": query(own, 1, 0, 128, 128),
                "seg_global": query(own, 1, 0, 128, 8000),
                "small_rows": query(own, 0, 1, K, K),
                "small_seg": query(own, 1, 1, TAIL_FUSED_K, TAIL_FUSED_K)}
    if name == "phrase_probe":
        return {f"S{s}": query(own, s) for s in (1, 3)}
    if name == "dense_flat":
        rows = {"rows_store": query(own, 0), "rows_cache": query(own, 1)}
        if not hasattr(lib, "dense_flat_topk_occupancy"):
            return rows
        topk = "dense_flat_topk_occupancy"
        return {"group": query(topk, 2, K), "select_store": query(topk, 0, K),
                "select_cache": query(topk, 1, K), **rows}
    return query(own)


def per_batch_launches(before: dict) -> dict:
    """Launches per timed batch since `before` (a `launch_counts()`), for
    the kernels that launched."""
    return {name: (n - before[name]) / TIMED_BATCHES
            for name, n in launch_counts().items() if n != before[name]}


def tail_records(log) -> list:
    """The merge-tail calls of a launch log: each kernel round's record
    holds its tail's form and inputs under "tail"."""
    return [rec["tail"] for rec in log if "tail" in rec]


def offload_tails(recs) -> None:
    """Moves the merge-tail inputs that launch-log records `recs` hold on
    the card to the host (`merge_tail_calls` moves them back for a
    replay), so that the log does not hold them in device memory."""
    import torch

    for rec in recs:
        tail = rec.get("tail")
        if tail is not None:
            tail["args"] = tuple(a.cpu() if torch.is_tensor(a) else a
                                 for a in tail["args"])


def check_tail_launches(path: str, launched: int, log) -> int:
    """K8 launched `launched` times on `path`, whose launch log is `log`:
    it must be the log's merge tails times K8's kernels a call. Returns
    the tails."""
    from tantivy_tpu_torch.ops import merge_tail

    n = len(tail_records(log))
    if launched != n * merge_tail.KERNELS_PER_CALL:
        raise AssertionError(f"{path}: merge_tail launched {launched} times "
                             f"for {n} merge tails of "
                             f"{merge_tail.KERNELS_PER_CALL} kernels")
    return n


def run_main_path(executor, logs, long_batch, n_seg: int):
    """One warm batch per suite, then TIMED_BATCHES fresh batches, then the
    untimed batch of longer phrases; returns per-suite timings, with the
    (query, segment) plans of the timed batches that the planner sent to
    the host engine by reason, and the (query, hits) pairs of the timed
    batches and of the longer phrases."""
    timing, answered = {}, {}
    for suite, qlog in logs.items():
        executor.search_batch(qlog[:BATCH], K)
        before = dict(executor.fallbacks)
        counts0 = launch_counts()
        n0 = len(executor.launch_log)
        with sweep_capture() as cap:
            qps, p50_ms, pairs, batch_log = timed_batches(
                executor.search_batch, qlog, executor.launch_log
            )
        launched = launch_counts()["ub_sweep"] - counts0["ub_sweep"]
        swept = [calls for _, calls in cap.sweeps if any(c[1] for c in calls)]
        if launched != len(swept):
            raise AssertionError(f"{suite}: {launched} UB sweep launches for "
                                 f"{len(swept)} sweeps with block rows")
        if suite in PROBE_SUITES[1:] and len(swept) < TIMED_BATCHES:
            raise AssertionError(f"{suite}: {len(swept)} UB sweeps in "
                                 f"{TIMED_BATCHES} timed batches")
        by_reason = {
            why: n - before.get(why, 0)
            for why, n in executor.fallbacks.items()
            if n != before.get(why, 0)
        }
        timing[suite] = {
            "qps": qps,
            "p50_ms": p50_ms,
            "host_plans": sum(by_reason.values()),
            "host_by_reason": by_reason,
            "plans": len(pairs) * n_seg,
            "launches_per_batch": per_batch_launches(counts0),
            "batch_log": batch_log,
            "tails": tail_records(executor.launch_log[n0:]),
            "sweeps": cap.sweeps,
        }
        answered[suite] = pairs
    answered["phrase34"] = list(
        zip(long_batch, executor.search_batch(long_batch, K))
    )
    return timing, answered


def probe_logs(logs) -> dict:
    """The probe path's suites: the boolean logs, each term query wrapped
    as a one-clause union (`search_boolean_batch` takes booleans only)."""
    import tantivy_tpu_torch as tt

    out = {suite: logs[suite] for suite in PROBE_SUITES}
    out["term"] = [tt.BooleanQuery.union([q]) for q in out["term"]]
    return out


def run_probe_path(executor, logs, n_seg: int):
    """`search_boolean_batch` on the boolean suites: one warm batch, then
    TIMED_BATCHES fresh batches per suite. Returns per-suite timings, with
    the timed batches' windowed-probe launches per rung, deep-path launches
    and host plans, and the (query, hits) pairs of the timed batches."""
    timing, answered = {}, {}
    for suite, qlog in probe_logs(logs).items():
        executor.search_boolean_batch(qlog[:BATCH], K)
        fb0 = sum(executor.fallbacks.values())
        stats0 = dict(executor.plan_stats)
        counts0 = launch_counts()
        n0 = len(executor.launch_log)
        qps, p50_ms, pairs, batch_log = timed_batches(
            executor.search_boolean_batch, qlog, executor.launch_log
        )

        def launched(kind):
            return (executor.plan_stats.get(kind, 0)
                    - stats0.get(kind, 0))

        timing[suite] = {
            "qps": qps,
            "p50_ms": p50_ms,
            "k3_by_kw": {kw: launched(f"probe_kw{kw}") for kw in PROBE_RUNGS},
            "deep": launched("probe_deep"),
            "host_plans": sum(executor.fallbacks.values()) - fb0,
            "plans": len(pairs) * n_seg,
            "launches_per_batch": per_batch_launches(counts0),
            "batch_log": batch_log,
            "tails": tail_records(executor.launch_log[n0:]),
        }
        answered[f"probe_{suite}"] = pairs
    return timing, answered


def run_phrase_seg(executor, logs, long_log, n_seg: int):
    """The per-segment phrase plan (`search_phrase_batch` of a
    `fused=False` executor, kernel K6) on the bigram phrase log and on the
    3-4 term phrase log: one warm batch, then TIMED_BATCHES fresh batches
    each. Returns per-suite timings, with the timed batches' K6 launches
    and host plans by reason, and the (query, hits) pairs of the timed
    batches."""
    timing, answered = {}, {}
    for suite, qlog in (("phrase_seg", logs["phrase"]),
                        ("phrase_seg34", long_log)):
        executor.search_phrase_batch(qlog[:BATCH], K)
        fb0 = dict(executor.fallbacks)
        stats0 = dict(executor.plan_stats)
        counts0 = launch_counts()
        n0 = len(executor.launch_log)
        qps, p50_ms, pairs, batch_log = timed_batches(
            executor.search_phrase_batch, qlog, executor.launch_log
        )
        by_reason = {why: executor.fallbacks.get(why, 0) - fb0.get(why, 0)
                     for why in PHRASE_SEG_HOST_REASONS}
        timing[suite] = {
            "qps": qps,
            "p50_ms": p50_ms,
            "k6_launches": executor.plan_stats.get("phrase_seg", 0)
                           - stats0.get("phrase_seg", 0),
            "host_plans": sum(by_reason.values()),
            "host_by_reason": by_reason,
            "plans": len(pairs) * n_seg,
            "launches_per_batch": per_batch_launches(counts0),
            "batch_log": batch_log,
            "tails": tail_records(executor.launch_log[n0:]),
        }
        answered[suite] = pairs
    return timing, answered


def run_segment_route(executor, logs, answered, n_seg: int):
    """Phase 4b: `search_batch` of a `fused=False` executor on each
    SEGMENT_SUITES log, one warm batch, then TIMED_BATCHES fresh batches.
    The hits of every timed batch must equal the main path's (`answered`)
    list for list, and each suite's timed batches must launch K7 twice a
    flat chunk, K3 once a planned windowed chunk, K4 once a planned deep
    chunk, K6 once a planned per-segment phrase chunk, K8 once a merge
    tail of the launch log and no other kernel.
    Then the first SEGMENT_PREFIX_QUERIES queries of the prefix log in one
    batch, with no warm batch, which must all run on the host engine with
    no launch. Returns per-suite timings, with launches, the planner's
    counts, host-routed queries and host plans by reason, the prefix
    batch's seconds, and the (query, hits) pairs of the timed batches."""
    import torch

    from tantivy_tpu_torch.ops import dense_flat, merge_tail

    timing, seg_answered = {}, {}
    for suite in SEGMENT_SUITES:
        qlog = logs[suite]
        executor.search_batch(qlog[:BATCH], K)
        fb0 = dict(executor.fallbacks)
        stats0 = dict(executor.plan_stats)
        routed0 = executor.host_routed
        counts0 = launch_counts()
        n0 = len(executor.launch_log)
        qps, p50_ms, pairs, _ = timed_batches(executor.search_batch, qlog,
                                              executor.launch_log)

        def planned(kind):
            return executor.plan_stats.get(kind, 0) - stats0.get(kind, 0)

        launched = {name: n - counts0[name]
                    for name, n in launch_counts().items()}
        flat = sum(rec["kind"] == "flat" for rec in executor.launch_log[n0:])
        tails = tail_records(executor.launch_log[n0:])
        k3_by_kw = {kw: planned(f"probe_kw{kw}") for kw in PROBE_RUNGS}
        want = {"dense_flat": flat * dense_flat.KERNELS_PER_CALL,
                "bool_probe": sum(k3_by_kw.values()),
                "deep_probe": planned("probe_deep"),
                "seg_phrase": planned("phrase_seg"),
                "merge_tail": len(tails) * merge_tail.KERNELS_PER_CALL}
        want = {name: want.get(name, 0) for name in launched}
        if launched != want:
            raise AssertionError(f"segment {suite}: launched {launched}, "
                                 f"the planner and launch log count {want}")
        if [bits(h) for _, h in pairs] != [
                bits(h) for _, h in answered[suite]]:
            raise AssertionError(f"segment {suite}: hits differ from the "
                                 "main path's")
        timing[suite] = {
            "qps": qps,
            "p50_ms": p50_ms,
            "launches_per_batch": {name: n / TIMED_BATCHES
                                   for name, n in launched.items() if n},
            "k3_by_kw": k3_by_kw,
            "flat_chunks": flat,
            "tails": tails,
            "host_routed": executor.host_routed - routed0,
            "host_by_reason": {
                why: n - fb0.get(why, 0)
                for why, n in executor.fallbacks.items()
                if n != fb0.get(why, 0)},
            "plans": len(pairs) * n_seg,
        }
        seg_answered[f"segment_{suite}"] = pairs
    prefixes = logs["prefix"][:SEGMENT_PREFIX_QUERIES]
    routed0 = executor.host_routed
    counts0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    executor.search_batch(prefixes, K)
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t0
    launched = {name: n - counts0[name]
                for name, n in launch_counts().items() if n != counts0[name]}
    if launched or executor.host_routed - routed0 != len(prefixes):
        raise AssertionError(
            f"segment prefix: {executor.host_routed - routed0} of "
            f"{len(prefixes)} queries on the host engine, launched {launched}")
    return timing, seg_answered, prefix_s


def check_exact(searcher, answered, seed: int) -> None:
    import tantivy_tpu_torch as tt

    rng = np.random.default_rng(seed + 3)
    for suite, pairs in answered.items():
        pick = rng.choice(len(pairs), min(EXACT_SAMPLE, len(pairs)),
                          replace=False)
        n_hits = 0
        t0 = time.perf_counter()
        for i in pick:
            q, dev = pairs[i]
            host = searcher.search(q, tt.TopDocs(K))
            if bits(dev) != bits(host):
                raise AssertionError(
                    f"{suite}: device hits differ from the host engine for "
                    f"{q!r}:\n device {dev}\n host   {host}"
                )
            n_hits += len(host)
        print(f"exact {suite}: {len(pick)} queries, {n_hits} hits equal "
              f"to the host engine ({time.perf_counter() - t0:.1f} s on the "
              f"host engine)")


def _same_hits(got, want) -> bool:
    return bits(got) == bits(want)


def timed_batch_lists(qlog) -> list:
    """The TIMED_BATCHES batches `timed_batches` runs, one list each."""
    return [qlog[b * BATCH:(b + 1) * BATCH]
            for b in range(1, 1 + TIMED_BATCHES)]


def run_pipelined(executor, logs, answered) -> dict:
    """`search_batches(pipeline=PIPELINE)` over each main-path suite's
    timed batches (all of them in flight at once); the results must equal the closed-loop
    results (`answered`) list for list. Returns per-suite QPS and the p50
    of `batch_spans`."""
    import torch

    out = {}
    for suite, qlog in logs.items():
        batches = timed_batch_lists(qlog)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = executor.search_batches(batches, K, pipeline=PIPELINE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        closed = [hits for _, hits in answered[suite]]
        flat = [hits for r in res for hits in r]
        if len(flat) != len(closed) or not all(
                _same_hits(g, w) for g, w in zip(flat, closed)):
            raise AssertionError(f"pipelined {suite}: results differ from "
                                 "the closed-loop results")
        out[suite] = {"qps": len(flat) / wall,
                      "p50_ms": float(np.median(executor.batch_spans)) * 1e3}
    return out


def run_term_batches(executor, searcher, logs, seed: int,
                     zero_counts) -> dict:
    """`search_term_batch` on the term log: one warm batch, then
    TIMED_BATCHES timed ones with every launch counter reset (`zero_counts`)
    just before and read just after; K7's launches must equal the flat
    chunks the launch log recorded for them times its kernels a call (the
    group and select kernels; k = K takes no row stage), and sampled hits
    must equal the host engine's. The flat scorer's calls of the first
    timed batch are replayed for their device ms (`_device_ms`: K7 alone),
    beside the route of k > 128 on the same chunks (K7's row stage and the
    torch merge tail), and their K7 chunks through the kernel and its twin
    (`dense_flat_vs_twin`)."""
    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.ops import dense_flat
    from tantivy_tpu_torch.ops.flat_scorer import flat_topk

    terms = [q.term for q in logs["term"]]
    executor.launch_log = []
    executor.search_term_batch(terms[:BATCH], K)
    n_warm = len(executor.launch_log)
    stats0 = dict(executor.plan_stats)
    zero_counts()
    qps, p50_ms, pairs, batch_log = timed_batches(
        executor.search_term_batch, terms, executor.launch_log)
    counts = launch_counts()
    by_kernel = dict(dense_flat.launches_by_kernel)
    chunks = sum(rec["kind"] == "flat"
                 for rec in executor.launch_log[n_warm:])
    executor.launch_log = None
    want = chunks * dense_flat.KERNELS_PER_CALL
    if counts["dense_flat"] != want or not chunks:
        raise AssertionError(f"the timed term batches launched dense_flat "
                             f"{counts['dense_flat']} times ({by_kernel}) "
                             f"for {chunks} flat chunks of "
                             f"{dense_flat.KERNELS_PER_CALL} kernels")
    if by_kernel != {"group": chunks, "select": chunks}:
        raise AssertionError(f"the timed term batches launched {by_kernel} "
                             f"K7 kernels for {chunks} flat chunks")
    rows_k = (executor.plan_stats.get("flat_rows_k", 0)
              - stats0.get("flat_rows_k", 0))
    if rows_k:
        raise AssertionError(f"k={K} took the row stage {rows_k} times")
    others = {n: c for n, c in counts.items() if c and n != "dense_flat"}
    if others:
        raise AssertionError(f"the term batches launched {others}")
    rng = np.random.default_rng(seed + 5)
    for i in rng.choice(len(pairs), EXACT_SAMPLE, replace=False):
        term, dev = pairs[i]
        host = searcher.search(tt.TermQuery(term), tt.TopDocs(K))
        if not _same_hits(dev, host):
            raise AssertionError(f"term batch: device hits differ from the "
                                 f"host engine for {term!r}:\n device {dev}"
                                 f"\n host   {host}")
    calls = [rec["args"] for rec in batch_log if rec["kind"] == "flat"]
    if not calls:
        raise AssertionError("the term batch made no flat scorer call")
    flat_ms = _device_ms([lambda a=a: flat_topk(*a) for a in calls])
    rows_ms = _device_ms([dense_rows_call(a) for a in calls])
    return {"qps": qps, "p50_ms": p50_ms, "flat_calls": len(calls),
            "flat_items": sum(int(a[1].shape[0]) for a in calls),
            "flat_ms": flat_ms, "rows_route_ms": rows_ms,
            "sampled": EXACT_SAMPLE, "pairs": pairs,
            "counts": counts, "by_kernel": by_kernel, "batch_log": batch_log,
            "launches_per_batch": counts["dense_flat"] / TIMED_BATCHES,
            **dense_flat_vs_twin(batch_log)}


def run_packed_term_batches(searcher, logs, dense_pairs, seed: int) -> dict:
    """`search_term_batch` of a packed-mode executor (kernel K5 over the
    bit-packed mirrors) on the term log: one warm pass over every batch of
    the log, then TIMED_BATCHES timed batches. The warm pass fills the
    executor's term-dictionary and BM25-weight caches, as the main path
    filled the dense executor's over the same log, so both time the same
    host work. Hits must equal the dense term batches' (`dense_pairs`)
    list for list, and sampled hits the host engine's. Returns the
    timings, the executor, its launch log, the K5 calls of the first timed
    batch, the merge tails of the timed batches and the mirror's size."""
    import torch

    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch import BatchExecutor
    from tantivy_tpu_torch.ops import packed_flat

    terms = [q.term for q in logs["term"]]
    t0 = time.perf_counter()
    executor = BatchExecutor(searcher, device="cuda", mode="packed")
    executor.launch_log = []
    executor.search_term_batch(terms[:BATCH], K)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for b in range(1, 1 + TIMED_BATCHES):
        executor.search_term_batch(terms[b * BATCH:(b + 1) * BATCH], K)
    n0 = packed_flat.launches
    n_log = len(executor.launch_log)
    qps, p50_ms, pairs, batch_log = timed_batches(
        executor.search_term_batch, terms, executor.launch_log)
    per_batch = (packed_flat.launches - n0) / TIMED_BATCHES
    log, executor.launch_log = executor.launch_log, None
    if len(pairs) != len(dense_pairs) or not all(
            _same_hits(g, w) for (_, g), (_, w) in zip(pairs, dense_pairs)):
        raise AssertionError("packed term batch: hits differ from the dense "
                             "term batches'")
    rng = np.random.default_rng(seed + 9)
    for i in rng.choice(len(pairs), EXACT_SAMPLE, replace=False):
        term, dev = pairs[i]
        host = searcher.search(tt.TermQuery(term), tt.TopDocs(K))
        if not _same_hits(dev, host):
            raise AssertionError(f"packed term batch: device hits differ "
                                 f"from the host engine for {term!r}")
    if not any(rec["kind"] == "packed_flat" for rec in batch_log):
        raise AssertionError("the packed term batch made no K5 call")
    dsegs = executor._device_segments
    return {"qps": qps, "p50_ms": p50_ms, "warm_s": warm_s,
            "launches_per_batch": per_batch, "executor": executor,
            "batch_log": batch_log, "sampled": EXACT_SAMPLE,
            "log": log, "tails": tail_records(log[n_log:]),
            "mirror_bytes": sum(d.packed_mirror("body", executor.device).nbytes
                                for d in dsegs),
            "blocks": sum(d.field_postings("body").num_blocks for d in dsegs),
            "segments": len(dsegs)}


def packed_flat_vs_twin(batch_log) -> dict:
    """Every K5 call of one packed term batch through the kernel and its
    twin: bitwise equal, the kernel timed by `_device_ms` and the twin
    between CUDA events, with the bytes it must move. Returns the sums over
    the batch and the largest chunk's (W, kernel ms, twin ms, bytes) and
    kernel call."""
    max_err, chunks = 0.0, []
    calls = [rec["args"] for rec in batch_log if rec["kind"] == "packed_flat"]
    for i, args in enumerate(calls):
        kern, twin = packed_flat_calls(args)
        err, _ = _compare(f"packed_flat chunk {i}", kern, twin)
        max_err = max(max_err, err)
        chunks.append((int(args[1].shape[0]), _single_ms([kern], 3),
                       _time_ms(twin, 3), packed_flat_bytes(args), kern))
    big = max(chunks, key=lambda c: c[0])
    return {"chunks": len(calls), "items": sum(c[0] for c in chunks),
            "ms": _device_ms([c[4] for c in chunks]),
            "twin_ms": sum(c[2] for c in chunks),
            "bytes": sum(c[3] for c in chunks), "max_abs_err": max_err,
            "big_chunk": big[:4], "big_call": big[4]}


def dense_flat_vs_twin(batch_log) -> dict:
    """Every K7 chunk of one dense term batch (its flat calls) through the
    kernel and its twin: bitwise equal, the kernel timed by `_device_ms`
    and the twin between CUDA events, with the bytes it must move. Returns
    the sums over the batch and the largest chunk's (W, kernel ms, twin
    ms, bytes, the route of k > 128's ms) and kernel call and that route's
    call."""
    max_err, chunks = 0.0, []
    calls = [rec["args"] for rec in batch_log if rec["kind"] == "flat"]
    for i, args in enumerate(calls):
        kern, twin = dense_flat_calls(args)
        err, _ = _compare(f"dense_flat chunk {i}", kern, twin)
        max_err = max(max_err, err)
        chunks.append((int(args[1].shape[0]), args, kern))
    W, args, kern = max(chunks, key=lambda c: c[0])
    twin = dense_flat_calls(args)[1]
    rows = dense_rows_call(args)
    big = (W, _single_ms([kern], 20), _time_ms(twin, 3),
           dense_flat_bytes(args), _single_ms([rows], 20))
    return {"k7_chunks": len(calls), "k7_ms": _device_ms(
                [c[2] for c in chunks]),
            "k7_twin_ms": sum(_time_ms(dense_flat_calls(c[1])[1], 3)
                              for c in chunks),
            "k7_bytes": sum(dense_flat_bytes(c[1]) for c in chunks),
            "max_abs_err": max_err, "big_chunk": big, "big_call": kern,
            "big_rows_call": rows}


def run_sharded(searcher, logs, answered, devices=SHARD_DEVICES) -> dict:
    """`ShardedSearcher` over `devices` on the SHARD_SUITES logs: one warm
    and TIMED_BATCHES timed batches each; hits must equal the single
    executor's (`answered`)."""
    from tantivy_tpu_torch.parallel.shard import ShardedSearcher

    t0 = time.perf_counter()
    sharded = ShardedSearcher(searcher, list(devices))
    out = {"setup_s": time.perf_counter() - t0, "suites": {}}
    for suite in SHARD_SUITES:
        qlog = logs[suite]
        sharded.search_batch(qlog[:BATCH], K)
        qps, p50_ms, pairs, _ = timed_batches(sharded.search_batch, qlog, [])
        single = answered[suite]
        if not all(_same_hits(g, w) for (_, g), (_, w) in zip(pairs, single)):
            raise AssertionError(f"sharded {suite}: hits differ from the "
                                 "single executor's")
        out["suites"][suite] = {"qps": qps, "p50_ms": p50_ms}
    out["segments_per_shard"] = [
        0 if ex is None else len(ex.searcher.segment_readers())
        for ex in sharded._execs]
    return out


def run_entry(zero_counts) -> dict:
    """The port's entry points on the card, with the counters reset just
    before and read just after: `entry()`'s forward must launch K7 and
    equal, bitwise, the same forward over the same tensors on the CPU
    (`entry(device="cpu")`, the twin); then `dryrun_multichip(4)` must
    pass. Returns the counts, the kernel's device ms on the entry's
    tensors and its bound, and the dry run's record."""
    import torch

    from tantivy_tpu_torch import entry

    zero_counts()
    fn, args = entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    out = entry.dryrun_multichip(4)
    counts = launch_counts()
    if counts["dense_flat"] < 1:
        raise AssertionError("the entry's forward launched no dense_flat "
                             "kernel")
    cfn, cargs = entry.entry(device="cpu")
    if any(not torch.equal(a.cpu(), b) for a, b in zip(args, cargs)):
        raise AssertionError("entry: the card's example tensors differ from "
                             "the CPU's")
    want = cfn(*cargs)
    if not (torch.equal(got[0].cpu().view(torch.int32),
                        want[0].view(torch.int32))
            and torch.equal(got[1].cpu(), want[1])):
        raise AssertionError("entry: the forward on the card differs from "
                             "its twin on the CPU")
    docs, tfs, valid, norm_ids, weights, caches, alive = args
    Q, B = docs.shape[:2]
    cache_args = (docs.reshape(Q * B, 128), tfs.reshape(Q * B, 128),
                  valid.reshape(-1),
                  torch.arange(Q * B, dtype=torch.int32,
                               device=docs.device) // B,
                  norm_ids, alive, weights, caches)
    kern, _ = dense_cache_calls(cache_args, 10, Q)
    return {"counts": counts, "dryrun": out,
            "finite": int(torch.isfinite(want[0]).sum()),
            "k7_ms": _single_ms([kern], 20),
            "bound_ms": bound_ms(dense_cache_bytes(cache_args, 10, Q))}


def build_side_index(stream, n_docs: int, seed: int):
    """`n_docs` windows of the stream with the bench's fast fields (`score`
    u64 in 0..999, `score_f64` ~ N(100, 30), ascending `ts`), in 2
    segments."""
    import tantivy_tpu_torch as tt

    b = tt.Schema.builder()
    b.add_text_field("body", tt.TEXT)
    b.add_u64_field("score", tt.FAST)
    b.add_f64_field("score_f64", tt.FAST)
    b.add_u64_field("ts", tt.FAST)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer(memory_budget=2_000_000_000, num_threads=1,
                     merge_policy=tt.NoMergePolicy())
    rng = np.random.default_rng(seed + 6)
    for i, body in enumerate(corpus(stream, n_docs, seed + 7)):
        w.add_document(tt.Document(
            body=body, score=int(rng.integers(0, 1000)),
            score_f64=float(rng.normal(100.0, 30.0)),
            ts=i * 10 + int(rng.integers(0, 10)),
        ))
        if i + 1 == n_docs // 2:
            w.commit()
    w.commit()
    w.close()
    return index


def range_log(rng, n_queries: int, n_docs: int) -> list:
    """Range queries at the bench's three selectivity bands (`bench.py`
    make_range_log): narrow low and high `score` ranges and a `ts` window
    of about 1%."""
    import tantivy_tpu_torch as tt

    out = []
    for i in range(n_queries):
        band = i % 3
        if band == 0:
            lo = int(rng.integers(0, 10))
            out.append(tt.RangeQuery("score", lower=lo, upper=lo + 9))
        elif band == 1:
            lo = int(rng.integers(985, 995))
            out.append(tt.RangeQuery("score", lower=lo, upper=lo + 5))
        else:
            lo = int(rng.integers(0, n_docs * 10))
            out.append(tt.RangeQuery("ts", lower=lo, upper=lo + n_docs // 10))
    return out


def run_side_index(stream, logs, seed: int, zero_counts,
                   device="cuda") -> dict:
    """The warmer, count and agg phases on a side index of SIDE_DOCS docs.
    The warmed executor's first batch (term queries) is the one run with
    the counters reset just before it; returns the ms of each phase and
    the group-probe launches of that batch."""
    import torch

    import tantivy_tpu_torch as tt
    from tantivy_tpu_torch.index import ReloadPolicy
    from tantivy_tpu_torch.ops import group_probe
    from tantivy_tpu_torch.parallel import BatchExecutor, DeviceSearchWarmer

    out = {}
    t0 = time.perf_counter()
    index = build_side_index(stream, SIDE_DOCS, seed)
    out["index_s"] = time.perf_counter() - t0
    batch = logs["term"][:BATCH]

    t0 = time.perf_counter()
    warmer = DeviceSearchWarmer(["body"], queries_hint=batch[:8],
                                device=device)
    reader = index.reader(ReloadPolicy.MANUAL, warmers=[warmer])
    searcher = reader.searcher()
    torch.cuda.synchronize()
    out["warm_ms"] = (time.perf_counter() - t0) * 1e3
    executor = BatchExecutor.for_searcher(searcher, device=device)
    if executor is not getattr(searcher, "_warm_executor", None):
        raise AssertionError("for_searcher did not return the warmed "
                             "executor")
    zero_counts()
    t0 = time.perf_counter()
    res = executor.search_batch(batch, K)
    torch.cuda.synchronize()
    out["first_batch_ms"] = (time.perf_counter() - t0) * 1e3
    out["first_batch_group_probe"] = group_probe.launches
    if group_probe.launches == 0:
        raise AssertionError("the warmed executor's first batch launched no "
                             "group_probe kernel")
    for q, dev in list(zip(batch, res))[:EXACT_SAMPLE]:
        if not _same_hits(dev, searcher.search(q, tt.TopDocs(K))):
            raise AssertionError(f"warmed executor: hits differ from the "
                                 f"host engine for {q!r}")

    queries = range_log(np.random.default_rng(seed + 8), BATCH, SIDE_DOCS)
    executor.count_batch(queries)  # the sorted-column caches
    t0 = time.perf_counter()
    counts = executor.count_batch(queries)
    out["count_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = [searcher.search(q, tt.Count()) for q in queries]
    out["count_host_ms"] = (time.perf_counter() - t0) * 1e3
    if counts != host:
        bad = sum(c != h for c, h in zip(counts, host))
        raise AssertionError(f"count_batch: {bad} counts differ from the "
                             "host Count")
    out["count_total"] = int(sum(counts))

    reqs = list(AGG_REQUESTS.values())
    executor.agg_batch(reqs)  # the per-reader column caches
    t0 = time.perf_counter()
    aggs = executor.agg_batch(reqs)
    out["agg_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = [searcher.search(tt.AllQuery(), tt.AggregationCollector(r))
            for r in reqs]
    out["agg_host_ms"] = (time.perf_counter() - t0) * 1e3
    for name, got, want in zip(AGG_REQUESTS, aggs, host):
        if json.dumps(got, sort_keys=True) != json.dumps(want, sort_keys=True):
            raise AssertionError(f"agg_batch {name}: differs from the "
                                 "AggregationCollector")
    return out


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compare(name, kernel, twin):
    """Run `kernel` and `twin` (no-argument calls returning (scores, docs))
    once each; scores must be bitwise equal and docs equal. Returns the
    largest score difference and the number of reported lanes."""
    import torch

    sc, dc = kernel()
    rsc, rdc = twin()
    torch.cuda.synchronize()
    if not torch.equal(sc.view(torch.int32), rsc.view(torch.int32)):
        bad = int((sc.view(torch.int32) != rsc.view(torch.int32)).sum())
        raise AssertionError(f"{name}: {bad} kernel scores differ from the "
                             "twin")
    if not torch.equal(dc, rdc):
        raise AssertionError(f"{name}: kernel docs differ from the twin")
    fin = torch.isfinite(rsc)
    err = float((sc[fin] - rsc[fin]).abs().max()) if fin.any() else 0.0
    return err, int(fin.sum())


def _phase2(th) -> bool:
    import torch

    return bool(torch.isfinite(th).any())


def pick_launches(log, kind: str, key, needed) -> list:
    """Real launch rounds to hold a kernel against its twin: the first
    round of each `key(rec)` value; every value in `needed` must occur."""
    chosen = {}
    for rec in log:
        if rec["kind"] == kind:
            chosen.setdefault(key(rec), rec)
    for need in needed:
        if need not in chosen:
            raise AssertionError(
                f"main path made no {kind} launch with {need}; the kernel "
                "check would be incomplete"
            )
    return sorted(chosen.items())


def synthetic_rows(log, kind: str, width: int, slab_rows=None):
    """The main path's largest real chunk of `kind` (of one slab rung, for
    the phrase kernel), its live groups repeated to fill `width` groups:
    real work at the largest tier's width."""
    mask_col = 3 if kind == "bool" else 2
    rec, rows = max(
        ((r, c[0] if kind == "bool" else c[1])
         for r in log if r["kind"] == kind for c in r["chunks"]
         if slab_rows is None or c[0] == slab_rows),
        key=lambda rc: int((rc[1][:, mask_col] != 0).sum()),
    )
    live = rows[rows[:, mask_col] != 0]
    reps = -(-width // live.shape[0])
    return rec, live.repeat(reps, 1)[:width].contiguous()


def group_calls(rec, rows):
    """(kernel, twin) no-argument calls of kernel K1 on one chunk."""
    from tantivy_tpu_torch.ops.group_probe import group_probe, group_probe_ref

    args = (rows, *rec["tables"], rec["cstore"])
    kw = dict(num_prows=rec["num_prows"], kk=min(rec["k"], 128))
    return (lambda: group_probe(*args, **kw),
            lambda: group_probe_ref(*args, **kw))


def phrase_calls(rec, rr, rows):
    """(kernel, twin) no-argument calls of kernel K2 on one chunk."""
    from tantivy_tpu_torch.ops.phrase_probe import (
        phrase_probe,
        phrase_probe_ref,
    )

    args = (rows, rec["qw"], rec["row_th"], rec["cstore"], rec["postore"])
    kw = dict(n_partners=rec["n_partners"], slab_rows=rr,
              num_prows=rec["num_prows"], kk=min(rec["k"], 128))
    return (lambda: phrase_probe(*args, **kw),
            lambda: phrase_probe_ref(*args, **kw))


def packed_flat_calls(args):
    """(kernel, twin) no-argument calls of kernel K5 on one logged chunk
    (`dispatch_packed_flat`'s args: mirror, blocks, qids, weights, caches,
    k, num_queries)."""
    from tantivy_tpu_torch.ops.packed_flat import packed_flat, packed_flat_ref

    mirror, blocks, qids, weights, caches, k, num_queries = args
    a = (*mirror, blocks, qids, weights, caches)
    kw = dict(num_queries=num_queries, kk=min(k, 128))
    return (lambda: packed_flat(*a, **kw), lambda: packed_flat_ref(*a, **kw))


def _unpacked(packed):
    """A packed [2, Q, k] result as (scores, docs) for `_compare`."""
    import torch

    return packed[0].view(torch.float32), packed[1]


def dense_flat_calls(args):
    """(kernel, twin) no-argument calls of kernel K7's store form on one
    logged flat chunk (`dispatch_flat`'s args: cstore, rows, qids,
    weights, k, num_queries): the per-query kernels for k <= 128, and
    `store_topk_ref` (the row stage's twin and the merge tail)."""
    from tantivy_tpu_torch.ops.dense_flat import (
        dense_flat_store,
        store_topk_ref,
    )

    cstore, rows, qids, weights, k, num_queries = args
    a = (cstore, rows, qids, weights)
    return (lambda: _unpacked(dense_flat_store(*a, k=k,
                                               num_queries=num_queries)),
            lambda: _unpacked(store_topk_ref(*a, k, num_queries)))


def dense_rows_call(args):
    """K7's row stage and the torch merge tail (K8's twin) on one logged
    flat chunk: the whole of K7 before it computed each query's top-k, and
    the route of k > 128 (`flat_scorer.flat_topk_rows`) before K8 took its
    tail."""
    from tantivy_tpu_torch.ops.dense_flat import MAX_K, dense_flat_rows_store
    from tantivy_tpu_torch.ops.merge_tail import twin

    cstore, rows, qids, weights, k, num_queries = args

    def call():
        sc, dc = dense_flat_rows_store(cstore, rows, qids, weights,
                                       kk=min(k, MAX_K))
        return _unpacked(twin(sc, dc, None, qids, k, num_queries))

    return call


def dense_cache_calls(args, k: int, num_queries: int):
    """(kernel, twin) no-argument calls of kernel K7's cache form on
    `dense_flat_cache`'s args, at k (k > 128: the row stage and
    `cache_merge`, as `_topk_kernel` routes it); each returns (scores,
    docs)."""
    from tantivy_tpu_torch.ops.dense_flat import (
        MAX_K,
        cache_merge,
        cache_topk_ref,
        dense_flat_cache,
        dense_flat_rows_cache,
    )

    if k <= MAX_K:
        kern = lambda: dense_flat_cache(*args, k=k,  # noqa: E731
                                        num_queries=num_queries)
    else:
        kern = lambda: cache_merge(  # noqa: E731
            *dense_flat_rows_cache(*args, kk=MAX_K), args[3], k, num_queries)
    return kern, lambda: cache_topk_ref(*args, k, num_queries)


def bool_calls(rec, rows):
    """(kernel, twin) no-argument calls of kernel K3 on one chunk."""
    from tantivy_tpu_torch.ops.bool_probe import bool_probe, bool_probe_ref

    args = (rows, *rec["tables"], rec["cstore"])
    kw = dict(kw=rec["kw"], num_queries=rec["num_queries"],
              kk=min(rec["k"], 128))
    return (lambda: bool_probe(*args, **kw),
            lambda: bool_probe_ref(*args, **kw))


def deep_calls(rec, rows=None):
    """(kernel, twin) no-argument calls of kernel K4 on one chunk."""
    from tantivy_tpu_torch.ops.deep_probe import deep_probe, deep_probe_ref

    args = (rec["rows"] if rows is None else rows, *rec["tables"],
            rec["cstore"], rec["blk_last"])
    kw = dict(num_queries=rec["num_queries"], kk=min(rec["k"], 128),
              n_iters=rec["n_iters"])
    return (lambda: deep_probe(*args, **kw),
            lambda: deep_probe_ref(*args, **kw))


def seg_phrase_calls(rec, rows=None):
    """(kernel, twin) no-argument calls of kernel K6 on one chunk."""
    from tantivy_tpu_torch.ops.phrase_scorer import seg_phrase, seg_phrase_ref

    args = (rec["rows"] if rows is None else rows, *rec["tables"],
            rec["cstore"], rec["postore"], rec["blk_pos"], rec["blk_last"])
    kw = dict(num_queries=rec["num_queries"], kk=min(rec["k"], 128),
              kw=rec["kw"], pw=rec["pw"], n_iters=rec["n_iters"])
    return (lambda: seg_phrase(*args, **kw),
            lambda: seg_phrase_ref(*args, **kw))


def merge_tail_calls(args):
    """(kernel, twin) no-argument calls of kernel K8 on one logged merge
    tail (a record's "tail" args: row_sc, row_doc, row_seg or None, qid,
    k, num_queries, on the card or the host), both on the card; each
    returns the packed result."""
    import torch

    from tantivy_tpu_torch.ops import merge_tail

    args = tuple(a.cuda() if torch.is_tensor(a) else a for a in args)
    sc, dc, seg, qid, k, num_queries = args
    if seg is None:
        kern = lambda: merge_tail.topk_from_rows(  # noqa: E731
            sc, dc, qid, k, num_queries)
    else:
        kern = lambda: merge_tail.topk_rows_seg(  # noqa: E731
            sc, dc, seg, qid, k, num_queries)
    return kern, lambda: merge_tail.twin(*args)


def merge_tail_bytes(args) -> int:
    """The bytes one K8 call must move: its candidates (score and doc),
    a qid a row (and a segment a row in the seg form) read once, the
    packed result written once."""
    sc, _, seg, _, k, num_queries = args
    W, kk = sc.shape
    planes = 2 if seg is None else 3
    return W * kk * 8 + W * 4 * (planes - 1) + num_queries * k * 4 * planes


# -- the least bytes each kernel must move ------------------------------
#
# Each counter takes one chunk as the launch log recorded it and counts
# once each distinct input byte the chunk needs, and each output byte:
# the scalar rows, the plan-row tables, the member cstore rows, the probed
# cstore window rows (docs and tfs) or postore sub-ranges (position and
# owner), and the [W, kk] scores and docs. For K1-K3 and K5 the cstore and
# postore ranges are those the kernel reads, computed from the chunk's
# real rows as the kernel computes them. K4's and K6's probes need a few
# words of rows spread over wide regions, so their counters count 32-byte
# sectors of the work itself, whatever a build loads: the sector that
# settles each probe, the hits' tf sectors and the positions compared, and
# no search step; every build of K4 or K6 is read against that one bound.


def _covered(n: int, lo, hi) -> np.ndarray:
    """[n] bool: which indices the ranges [lo, hi) cover."""
    lo = np.maximum(np.asarray(lo, dtype=np.int64), 0)
    hi = np.minimum(np.asarray(hi, dtype=np.int64), n)
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    diff = (np.bincount(lo, minlength=n + 1)
            - np.bincount(hi, minlength=n + 1))
    return np.cumsum(diff[:n]) > 0


def _union_len(lo, hi) -> int:
    """How many integers the ranges [lo, hi) cover together."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    keep = hi > lo
    if not keep.any():
        return 0
    order = np.argsort(lo[keep], kind="stable")
    lo, hi = lo[keep][order], hi[keep][order]
    reach = np.maximum.accumulate(hi)
    # a range starts a new run of overlapping ranges when it begins past
    # every earlier range's end
    starts = np.nonzero(np.r_[True, lo[1:] > reach[:-1]])[0]
    return int((np.maximum.reduceat(hi, starts) - lo[starts]).sum())


def _np(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


def _small_bytes(rows, tables, kk: int) -> int:
    """Scalar rows, plan-row tables and the [W, kk] outputs."""
    return (rows.numel() * 4 + sum(t.numel() * 4 for t in tables)
            + rows.shape[0] * kk * 8)


def group_probe_bytes(rec, rows) -> int:
    """Kernel K1: member rows (docs, tfs, cachev: 1,536 bytes) and each
    clause's probed member sub-windows (docs and tfs: 1,024 bytes a row)."""
    r = _np(rows)
    T, nb = rec["n_clauses"], rec["cstore"].shape[0]
    prow, mask = r[:, 1], r[:, 3]
    live = (mask != 0) & (prow >= 0) & (prow < rec["num_prows"])
    m_lo, p_lo, p_hi = [], [], []
    for m in range(8):
        sel = live & (((mask >> m) & 1) == 1)
        m_lo.append(r[sel, 0] + m)
        for t in range(T):
            jlo = r[sel, 4 + t]
            packed = r[sel, 4 + T + 8 * t + m]
            ln = packed & 255
            ok = (ln > 0) & (jlo >= 0)
            p_lo.append((jlo + (packed >> 8))[ok])
            p_hi.append((jlo + (packed >> 8) + ln)[ok])
    m_lo = np.concatenate(m_lo)
    member = _covered(nb, m_lo, m_lo + 1)
    probed = _covered(nb, np.concatenate(p_lo), np.concatenate(p_hi))
    return (int(member.sum()) * 1536 + int((probed & ~member).sum()) * 1024
            + _small_bytes(rows, rec["tables"], min(rec["k"], 128)))


def phrase_probe_bytes(rec, rr: int, rows) -> int:
    """Kernel K2: member rows (docs and cachev: 1,024 bytes) and every
    position of the anchor and partner sub-ranges, cut to the slab window
    as the kernel cuts them (position and owner: 8 bytes each)."""
    r = _np(rows)
    S, nb = rec["n_partners"], rec["cstore"].shape[0]
    n_pos = rec["postore"].shape[0] * 128
    A = 4 + 2 * S
    prow, mask = r[:, 1], r[:, 2]
    live = (mask != 0) & (prow >= 0) & (prow < rec["num_prows"])

    def window(row0):
        lim = np.clip((rec["postore"].shape[0] - row0) * 128, 0, rr * 128)
        return row0 * 128, lim

    m_lo, lo, hi = [], [], []
    for m in range(8):
        sel = live & (((mask >> m) & 1) == 1)
        m_lo.append(r[sel, 0] + m)
        ranges = [(r[sel, 3], r[sel, A + m], r[sel, A + 8 + m])]
        ranges += [(r[sel, 4 + 2 * s], r[sel, A + 16 + 16 * s + m],
                    r[sel, A + 24 + 16 * s + m]) for s in range(S)]
        # partners are searched only for the member's anchor positions
        has_anchor = ranges[0][2] > 0
        for row0, off, ln in ranges:
            base, lim = window(row0)
            ok = (ln > 0) & has_anchor
            lo.append((base + np.maximum(off, 0))[ok])
            hi.append((base + np.minimum(off + ln, lim))[ok])
    m_lo = np.concatenate(m_lo)
    member = _covered(nb, m_lo, m_lo + 1)
    lo = np.concatenate(lo)
    n_pos_read = _union_len(lo, np.minimum(np.concatenate(hi), n_pos))
    return (int(member.sum()) * 1024 + n_pos_read * 8
            + _small_bytes(rows, (rec["qw"], rec["row_th"]),
                           min(rec["k"], 128)))


def bool_probe_bytes(rec, rows) -> int:
    """Kernel K3: each item's own row (docs, tfs, cachev: 1,536 bytes) and
    each clause's probed window rows inside its region (docs and tfs: 1,024
    bytes a row), the rows the kernel's rungs probe."""
    r = _np(rows)
    T, kw = rec["n_clauses"], rec["kw"]
    nb = rec["cstore"].shape[0]
    cl_start, cl_len = _np(rec["tables"][2]), _np(rec["tables"][3])
    bid, q = r[:, 0], r[:, 1]
    live = (q >= 0) & (q < rec["num_queries"]) & (bid >= 0) & (bid < nb)
    bid, q, r = bid[live], q[live], r[live]
    kw8 = ((kw + 7) & ~7) + (8 if kw > 8 else 0)
    p_lo, p_hi = [], []
    for t in range(T):
        s0 = cl_start[q, t]
        e = s0 + cl_len[q, t]
        j = r[:, 3 + t]
        if kw <= 8:
            r1 = j + max(kw, 2)
        else:
            used = np.clip(np.minimum(e - j, r[:, 3 + T + t]), 0, kw8)
            r1 = j + ((used + 7) & ~7)
        ok = j >= 0
        p_lo.append(np.maximum(j, s0)[ok])
        p_hi.append(np.minimum(r1, e)[ok])
    member = _covered(nb, bid, bid + 1)
    probed = _covered(nb, np.concatenate(p_lo), np.concatenate(p_hi))
    return (int(member.sum()) * 1536 + int((probed & ~member).sum()) * 1024
            + _small_bytes(rows, rec["tables"], min(rec["k"], 128)))


#: bytes a device memory load moves at least (one sector)
SECTOR = 32
#: 4-byte words of one sector, and sectors of one 384-word cstore row
SECTOR_WORDS = SECTOR // 4
ROW_SECTORS = 384 // SECTOR_WORDS


def region_lower_bound(keys, lo, hi, doc):
    """The first index i in [lo, hi) with keys[i] >= doc, or hi, over many
    probes at once (binary steps); keys ascend inside each [lo, hi).
    `lo`, `hi` and `doc` are int64 tensors of one length."""
    import torch

    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        on = lo < hi
        mid = (lo + hi) >> 1
        below = keys[mid.clamp(0, keys.numel() - 1)].long() < doc
        lo = torch.where(on & below, mid + 1, lo)
        hi = torch.where(on & ~below, mid, hi)
    return lo


def probe_sectors(cstore, blk_last, lo, hi, doc):
    """Where each doc lies in the rows [lo, hi) of a region, and the
    sectors that settle it: the row that holds the doc or would (the first
    whose last doc is >= it; `hi` when none), the lane of the doc's lower
    bound in that row, whether the doc is there, its tf, and the cstore
    sector of that lane's doc (for the probes with a row) and of its tf
    (for the hits)."""
    import torch

    row = region_lower_bound(blk_last, lo, hi, doc)
    has = row < hi
    r = row[has]
    d = doc[has]
    lane = torch.searchsorted(cstore[r, :128].contiguous(),
                              d[:, None].to(cstore.dtype))[:, 0].long()
    lane = lane.clamp(max=127)
    hit = torch.zeros_like(has)
    hit[has] = cstore[r, lane].long() == d
    tf = torch.zeros_like(doc)
    lane_all = torch.zeros_like(doc)
    lane_all[has] = lane
    tf[hit] = cstore[row[hit], 128 + lane_all[hit]].long()
    doc_sec = r * ROW_SECTORS + lane // SECTOR_WORDS
    tf_sec = (row[hit] * ROW_SECTORS + 16
              + lane_all[hit] // SECTOR_WORDS)
    return row, lane_all, hit, tf, doc_sec, tf_sec


def deep_probe_bytes(rec, rows) -> int:
    """Kernel K4: the bytes one chunk's work needs, as distinct 32-byte
    sectors, whatever a kernel loads: each real item's own row (docs, tfs
    and denominators: 48 sectors); for each live lane and each other clause
    with a region, the docs sector of the region row that holds its doc or
    would (the first whose last doc is at least it; none past the region)
    and, on a hit, its tf sector; plus the launch rows, the tables and the
    [W, kk] outputs. No search step (`blk_last` words, fences, pivots)
    counts. Sectors are counted from the start of `cstore` (torch
    allocations start on a 512-byte boundary)."""
    import torch

    cstore, blk_last = rec["cstore"], rec["blk_last"]
    nb = cstore.shape[0]
    r = rows.to(cstore.device).long()
    bid, q, lcl = r[:, 0], r[:, 1], r[:, 2]
    real = (q >= 0) & (q < rec["num_queries"]) & (bid >= 0) & (bid < nb)
    bid, q, lcl = bid[real], q[real], lcl[real]
    own = cstore[bid]
    docs = own[:, :128].long()
    lane_ok = (docs != 2**31 - 1) & ~own[:, 256:].view(torch.float32).isnan()
    member = torch.unique(bid)
    row_sec = [(member[:, None] * ROW_SECTORS
                + torch.arange(ROW_SECTORS, device=bid.device)).view(-1)]
    cl_start = rec["tables"][2].to(bid.device).long()
    cl_len = rec["tables"][3].to(bid.device).long()
    for t in range(cl_start.shape[1]):
        s = cl_start[q, t]
        e = torch.minimum(s + cl_len[q, t], torch.full_like(s, nb))
        probed = (lcl != t) & (s >= 0) & (e > s)
        item, lane = torch.nonzero(lane_ok & probed[:, None], as_tuple=True)
        *_, doc_sec, tf_sec = probe_sectors(cstore, blk_last, s[item],
                                            e[item], docs[item, lane])
        row_sec += [doc_sec, tf_sec]
    return (SECTOR * torch.unique(torch.cat(row_sec)).numel()
            + _small_bytes(rows, rec["tables"], min(rec["k"], 128)))


def _spans(lo, n):
    """The integers of the ranges [lo, lo + n), concatenated."""
    import torch

    idx = torch.repeat_interleave(torch.arange(lo.numel(), device=lo.device),
                                  n)
    first = torch.cumsum(n, 0) - n
    return lo[idx] + torch.arange(idx.numel(), device=lo.device) - first[idx]


def _pos_sectors(n_pos: int, idx):
    """The postore sectors holding flat positions `idx` (clamped to the
    store as the kernel clamps them): position i is word (i >> 7) * 256 +
    (i & 127)."""
    idx = idx.clamp(0, n_pos - 1)
    return ((idx >> 7) * 256 + (idx & 127)) // SECTOR_WORDS


def seg_phrase_bytes(rec, rows) -> int:
    """Kernel K6: the bytes one chunk's work needs, as distinct 32-byte
    sectors, whatever a kernel loads: each real item's docs and
    denominators (32 sectors); for each live lane and each term it reaches
    (in term order until one misses), the docs sector of the window row
    that holds its doc or would (the first whose last doc is at least it;
    none past the window) and, on a hit, its tf sector and the row's
    `blk_pos` entry; for the lanes every term holds, the leader's first
    min(tf, MAX_P) positions and each other term's positions up to the
    first at or above the leader's last aligned position (in term order,
    until no leader position is left matching); plus the launch rows, the
    tables and the [W, kk] outputs. No search step (`blk_last` words,
    fences, pivots) counts. Sectors count from the start of each tensor
    (torch allocations start on a 512-byte boundary)."""
    import torch

    from tantivy_tpu_torch.ops.phrase_scorer import MAX_P

    cstore, blk_last = rec["cstore"], rec["blk_last"]
    postore, blk_pos = rec["postore"], rec["blk_pos"]
    dev = cstore.device
    nb, n_pos = cstore.shape[0], postore.shape[0] * 128
    pos_flat = postore.view(-1)
    kw, pw = rec["kw"], rec["pw"]
    q_weight, cl_start, cl_len, cl_shift = (t.to(dev) for t in rec["tables"])
    T = cl_start.shape[1]
    r = rows.to(dev).long()
    bid, q, lead = r[:, 0], r[:, 1], r[:, 2]
    real = (q >= 0) & (q < rec["num_queries"]) & (bid >= 0) & (bid < nb)
    bid, q, lead = bid[real], q[real], lead[real].clamp(0, T - 1)
    own = cstore[bid]
    docs = own[:, :128].long()
    live = (docs != 2**31 - 1) & ~own[:, 256:].view(torch.float32).isnan()
    member = torch.unique(bid)
    ar = torch.arange(16, device=dev)
    row_sec = [(member[:, None] * ROW_SECTORS + ar).view(-1),
               (member[:, None] * ROW_SECTORS + 32 + ar).view(-1)]
    bp_sec, pos_sec = [], []
    # each term's window [lo, hi): from the lower bound of the item's first
    # doc, kw rows, cut to the region (empty for an empty region)
    s = cl_start[q].long()
    n = cl_len[q].long()
    e = torch.clamp(s + n, max=nb)
    lo, hi = s.clone(), s.clone()
    for t in range(T):
        ok = (n[:, t] > 0) & (s[:, t] >= 0) & (e[:, t] > s[:, t])
        j = region_lower_bound(blk_last, s[ok, t], e[ok, t], docs[ok, 0])
        lo[ok, t] = j
        hi[ok, t] = torch.minimum(j + kw, e[ok, t])
    item, lane = torch.nonzero(live, as_tuple=True)
    d = docs[item, lane]
    act = torch.ones_like(d, dtype=torch.bool)
    tf_t = torch.zeros((d.numel(), T), dtype=torch.long, device=dev)
    pb_t = torch.zeros_like(tf_t)
    for t in range(T):
        at = torch.nonzero(act, as_tuple=True)[0]
        row, ln, hit, tf, doc_sec, tf_sec = probe_sectors(
            cstore, blk_last, lo[item[at], t], hi[item[at], t], d[at])
        row_sec += [doc_sec, tf_sec]
        h, row, ln = at[hit], row[hit], ln[hit]
        bp_sec.append(row // SECTOR_WORDS)
        excl = (torch.cumsum(cstore[row, 128:256].long(), 1)
                - cstore[row, 128:256].long())
        tf_t[h, t] = tf[hit]
        pb_t[h, t] = (blk_pos[row].long()
                      + excl.gather(1, ln[:, None])[:, 0])
        act = torch.zeros_like(act)
        act[h] = True
    # the count, for the lanes every term holds
    sel = torch.nonzero(act, as_tuple=True)[0]
    ld = lead[item[sel]]
    tf_t, pb_t = tf_t[sel], pb_t[sel]
    shift = cl_shift[q[item[sel]]].long()
    jmax = tf_t.gather(1, ld[:, None])[:, 0].clamp(max=MAX_P)
    pl = pb_t.gather(1, ld[:, None])[:, 0]
    jj = torch.arange(MAX_P, device=dev)
    want = jj[None, :] < jmax[:, None]
    lidx = pl[:, None] + jj
    pos_sec.append(_pos_sectors(n_pos, lidx[want]))
    lp = pos_flat[((lidx.clamp(0, n_pos - 1) >> 7) * 256
                   + (lidx.clamp(0, n_pos - 1) & 127))].long()
    mask = want.clone()
    shl = shift.gather(1, ld[:, None])
    big = 2**40
    for t in range(T):
        use = torch.nonzero((ld != t) & mask.any(dim=1), as_tuple=True)[0]
        lim = tf_t[use, t].clamp(max=pw)
        pt = pb_t[use, t]
        pidx = (pt[:, None] + torch.arange(pw, device=dev)).clamp(
            0, n_pos - 1)
        vals = pos_flat[(pidx >> 7) * 256 + (pidx & 127)].long()
        vals = torch.where(torch.arange(pw, device=dev)[None, :]
                           < lim[:, None], vals, big)
        target = lp[use] + (shl[use] - shift[use, t, None])
        last = target.gather(1, (jmax[use] - 1).clamp(min=0)[:, None])
        stop = torch.searchsorted(vals.contiguous(), last.contiguous())[:, 0]
        pos_sec.append(_pos_sectors(
            n_pos, _spans(pt, torch.minimum(stop + 1, lim))))
        at = torch.searchsorted(vals.contiguous(), target.contiguous())
        m = vals.gather(1, at.clamp(max=pw - 1)) == target
        mask[use] &= m
    n_sec = sum(torch.unique(torch.cat(x)).numel()
                for x in (row_sec, bp_sec, pos_sec) if x)
    return (SECTOR * n_sec
            + _small_bytes(rows, rec["tables"], min(rec["k"], 128)))


def packed_flat_bytes(args) -> int:
    """Kernel K5: each distinct block's packed doc and tf words (16 bytes
    per bit of width) and table row (32 bytes), the alive byte of each
    distinct doc in those blocks and the norm-id byte of each live one, the
    items (block id and qid), each query's weight and denominator table,
    and the [W, kk] outputs."""
    import torch

    from tantivy_tpu_torch.ops.decode import decode_blocks

    mirror, blocks, qids, weights, caches, k, num_queries = args
    uniq = torch.unique(blocks)
    tab = _np(mirror.blk_tab[uniq.long()])
    docs, _ = decode_blocks(*mirror[:3], uniq)
    docs = torch.unique(docs[docs != 2**31 - 1]).long()
    n_live = int(mirror.alive[docs].sum())
    q = _np(torch.unique(qids))
    n_q = int((q < num_queries).sum())
    W = blocks.shape[0]
    return (int(16 * (tab[:, 1] + tab[:, 3]).sum()) + 32 * len(tab)
            + docs.numel() + n_live + 8 * W
            + n_q * (weights.element_size() + caches[0].numel() * 4)
            + W * min(k, 128) * 8)


def dense_flat_bytes(args) -> int:
    """Kernel K7's store form on one flat chunk, the bytes the function
    needs: each distinct cstore row once (1,536 bytes), the items (an
    8-byte row and a 4-byte qid each), each distinct query's weight, and
    the output: for k <= 128 each query's [k] scores and docs, above it the
    row stage's [W, 128] scores and docs. The term log repeats frequent
    terms, so rows repeat across items. What K7 itself adds to group the
    items by query (a second read of the qids, the item order, the offsets)
    is not counted."""
    import torch

    from tantivy_tpu_torch.ops.dense_flat import MAX_K

    cstore, rows, qids, weights, k, num_queries = args
    W = rows.shape[0]
    n_rows = torch.unique(rows).numel()
    n_q = torch.unique(qids).numel()
    out = num_queries * k * 8 if k <= MAX_K else W * MAX_K * 8
    return (n_rows * cstore.shape[1] * 4 + 12 * W
            + n_q * weights.element_size() + out)


def dense_cache_bytes(args, k: int, num_queries: int) -> int:
    """Kernel K7's cache form, the bytes the function needs: each row's
    docs and tfs (1,024 bytes) and valid byte, the alive and norm-id bytes
    of its distinct real docs, each distinct query's weight and denominator
    table, and the output: each query's [k] scores and docs for k <= 128,
    the row stage's [W, 128] scores, docs and lanes above. A row's query is
    its position (the reference's `_topk_kernel` takes no qids), so the
    qids the kernel is handed are not counted."""
    import torch

    from tantivy_tpu_torch.ops.dense_flat import MAX_K

    docs, tfs, valid, qids, norm_ids, alive, weights, caches = args
    W = docs.shape[0]
    real = docs[docs != 2**31 - 1]
    n_docs = torch.unique(real).numel()
    n_q = torch.unique(qids).numel()
    out = num_queries * k * 8 if k <= MAX_K else W * MAX_K * 9
    return (W * (1024 + 1) + n_docs * (1 + (alive is not None))
            + n_q * (4 + caches.shape[1] * 4) + out)


def _rounded(v):
    if v is None or isinstance(v, str):
        return v
    if isinstance(v, dict):
        return {k: _rounded(x) for k, x in v.items()}
    if isinstance(v, (bool, list)):
        return v
    return round(v, 6)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def chunk_work(rec):
    """(kernel name, kernel call, bytes, the call an earlier build of the
    kernel runs) for each chunk of one launch record, and for its merge
    tail (K8)."""
    if "tail" in rec:
        args = rec["tail"]["args"]
        call = merge_tail_calls(args)[0]
        yield ("merge_tail", call, merge_tail_bytes(args), call)
    if rec["kind"] == "bool":
        for rows, _, _ in rec["chunks"]:
            call = group_calls(rec, rows)[0]
            yield ("group_probe", call, group_probe_bytes(rec, rows), call)
    elif rec["kind"] == "phrase":
        for rr, rows, _, _ in rec["chunks"]:
            call = phrase_calls(rec, rr, rows)[0]
            yield ("phrase_probe", call, phrase_probe_bytes(rec, rr, rows),
                   call)
    elif rec["kind"] == "packed_flat":
        call = packed_flat_calls(rec["args"])[0]
        yield ("packed_flat", call, packed_flat_bytes(rec["args"]), call)
    elif rec["kind"] == "flat":
        # an earlier K7 is its row stage: the route of k > 128 runs it
        yield ("dense_flat", dense_flat_calls(rec["args"])[0],
               dense_flat_bytes(rec["args"]), dense_rows_call(rec["args"]))
    elif rec["kind"] == "deep":
        call = deep_calls(rec)[0]
        yield ("deep_probe", call, deep_probe_bytes(rec, rec["rows"]), call)
    elif rec["kind"] == "seg_phrase":
        call = seg_phrase_calls(rec)[0]
        yield ("seg_phrase", call, seg_phrase_bytes(rec, rec["rows"]), call)
    else:
        call = bool_calls(rec, rec["rows"])[0]
        yield ("bool_probe", call, bool_probe_bytes(rec, rec["rows"]), call)


#: spin kernels launched before and after the calls of each profiler
#: session of `_device_ms`, not counted in its time
PAD_KERNELS = 4


def _device_ms(calls, reps: int = 3, attempts: int = 4):
    """Device time of one pass over `calls` (no-argument calls, each of
    which launches at least one kernel), from torch.profiler: the summed
    durations of the CUDA kernels and copies they run, averaged over
    `reps` passes after a warm one. CUDA events around a single call also
    hold the host time between its events, the wrapper's checks and
    allocations (tens of microseconds), which a kernel of a few
    microseconds cannot hide. The profiler has been seen to deliver no
    device event for a whole pass, and fewer device events than the calls
    launched kernels (on an H100, a 12-chunk term batch once read 0.0015
    ms where its other passes read about 0.19, single-chunk sessions
    missed 2 events of 20, and a pass of K7's row stage and torch merge
    tail read 0.97 ms where others read 3.07). So each session starts and
    ends with PAD_KERNELS spin kernels (`torch.cuda._sleep`, left out of
    the time); a session counts only if it holds a device event for every
    call and for every launch the port's counters saw, and only once a
    second session of up to `attempts` has recorded the same number of
    device events (the torch kernels of a call are not counted
    elsewhere): the reading is the mean of those sessions. Otherwise the
    reading is incomplete: it returns None (and prints the sessions'
    counts), never a short pass's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(100)

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            n0 = sum(launch_counts().values())
            for _ in range(reps):
                for fn in calls:
                    fn()
            n1 = sum(launch_counts().values())
            pad()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        work = [ev for ev in evs if "spin_kernel" not in ev.key]
        # an unnamed pad would count as work: then it must be there too
        want = max(reps * len(calls), n1 - n0) + (
            2 * PAD_KERNELS if len(work) == len(evs) else 0)
        total = sum(ev.self_device_time_total for ev in work)
        n_events = sum(ev.count for ev in work)
        if total and n_events >= want:
            agree = [t for n, t in seen if n == n_events]
            if agree and n_events >= max(n for n, _ in seen):
                return (sum(agree) + total) / (len(agree) + 1) / reps / 1e3
        seen.append((n_events, total))
    print(f"_device_ms: incomplete: torch.profiler recorded "
          f"{[n for n, _ in seen]} device events in {attempts} sessions "
          f"of {want} or more launches")
    return None


class Reading(float):
    """A time in ms with how it was taken, `source`: "profiler"
    (torch.profiler's device time) or "cuda_events" (CUDA events around
    the calls, which also hold the wrappers' host time)."""

    def __new__(cls, ms: float, source: str):
        self = super().__new__(cls, ms)
        self.source = source
        return self


def _single_ms(calls, reps: int = 20) -> Reading:
    """`_device_ms` of one chunk's calls; when the profiler's reading is
    incomplete, the time between CUDA events around `reps` passes, its
    source recorded as "cuda_events" (`_reading_text`, `_sources`)."""
    ms = _device_ms(calls, reps)
    if ms is not None:
        return Reading(ms, "profiler")
    return Reading(sum(_time_ms(fn, reps) for fn in calls), "cuda_events")


def _queued_ms(calls, reps: int = 3, attempts: int = 4):
    """Device time of one pass over `calls` from CUDA events around `reps`
    passes enqueued behind a spin kernel (`torch.cuda._sleep`): the host
    enqueues every call while the card spins, so the events time the
    calls' kernels back to back, not the host's work between them. A
    reading counts only if the start event had not yet fired when the last
    call was enqueued; else the spin grows fourfold and the passes run
    again. Returns None when no attempt hid the host's enqueueing."""
    import torch

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            for fn in calls:
                fn()
        end.record()
        hidden = not start.query()
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps
        cycles *= 4
    return None


def _reading_text(ms: Reading) -> str:
    if ms.source == "profiler":
        return f"{ms:.4f} ms device time"
    return f"{ms:.4f} ms between CUDA events (host time included)"


def _sources(stats: dict) -> dict:
    """How each `Reading` of a kernel's record (and of its dicts of
    readings) was taken."""
    out = {}
    for key, v in stats.items():
        if isinstance(v, Reading):
            out[key] = v.source
        elif isinstance(v, dict):
            sub = {tag: x.source for tag, x in v.items()
                   if isinstance(x, Reading)}
            if sub:
                out[key] = sub
    return out


def _ms_text(ms) -> str:
    return "incomplete" if ms is None else f"{ms:.4f} ms"


def _same(a, b) -> bool:
    import torch

    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def occupancy_text(occ: dict) -> str:
    """`occupancy()`'s record as text: CTAs resident per SM, threads per
    CTA and shared memory per CTA (per partner count for the phrase
    kernel)."""
    if "threads" in occ:
        return (f"{occ['ctas_per_sm']} CTAs/SM of {occ['threads']} threads "
                f"at {occ['smem_bytes']} B smem")
    return ", ".join(f"{key}: {occupancy_text(v)}" for key, v in occ.items())


def batch_kernel_times(timings: dict, baselines: dict, occ: dict) -> dict:
    """Per kernel and suite: the real chunks of one timed batch replayed
    through the kernel; the kernel's device ms over the batch's chunks
    (`_queued_ms`: CUDA events around the calls enqueued behind a spin
    kernel); the bytes the chunks must move, the bound
    (those bytes at the card's memory rate) and the share of the bound the
    device ms reach, beside the launches per timed batch and the kernel's
    occupancy (`occ`, from `occupancy()`). `baselines` maps a name to
    {kernel: library}: the chunks also run through those (K7's through its
    row stage and the torch merge, the calls an earlier build has), timed
    between two passes of the current kernel (whose ms is the mean of
    both), and the chunks whose output differs from the current kernel's
    are counted. For the merge tail (K8) the twin's device ms over the
    same calls (the torch tail every path ran before K8) stands beside,
    from `_device_ms` (torch.profiler): the host does not get ahead of
    the torch tail, so a spin kernel cannot hide its enqueueing. An entry
    whose reading is incomplete says so and gives no ms."""
    out = {}
    for suite, tm in timings.items():
        work = {}
        for rec in tm["batch_log"]:
            for name, call, n_bytes, base_call in chunk_work(rec):
                w = work.setdefault(name, {"calls": [], "base": [],
                                           "bytes": 0})
                w["calls"].append(call)
                w["base"].append(base_call)
                w["bytes"] += n_bytes
        for name, w in work.items():
            calls, n_bytes = w["calls"], w["bytes"]
            wants = [call() for call in calls]
            first = _queued_ms(calls)
            base_ms, differs = {}, {}
            for tag, libs in baselines.items():
                if libs.get(name) is None:
                    continue
                with kernel_lib(name, libs[name]):
                    base_ms[tag] = _queued_ms(w["base"])
                    differs[tag] = sum(not _same(call(), want)
                                       for call, want in zip(w["base"],
                                                             wants))
            ms = first
            if base_ms:
                second = _queued_ms(calls)
                ms = None if None in (first, second) else (first + second) / 2
            b = bound_ms(n_bytes)
            twin = {}
            if name == "merge_tail":
                # the torch tail every path ran before K8, on the same calls
                twin = {"twin_ms": _device_ms(
                    [merge_tail_calls(t["args"])[1]
                     for t in tail_records(tm["batch_log"])])}
            rec = {
                "launches_per_batch": tm["launches_per_batch"].get(name, 0),
                "chunks": len(calls), "bytes": n_bytes, "bound_ms": b,
                **({"ms": ms, "share": b / ms} if ms is not None
                   else {"incomplete": True}),
                **twin,
                **({"baseline_ms": {tag: v for tag, v in base_ms.items()
                                    if v is not None},
                    "baseline_incomplete": [tag for tag, v in base_ms.items()
                                            if v is None],
                    "baseline_differs": differs} if base_ms else {}),
            }
            out.setdefault(name, {})[suite] = rec
            base = "".join(f"; {tag} {_ms_text(bms)} ({differs[tag]} chunks "
                           "differ)" for tag, bms in base_ms.items())
            share = (f"share of bound {b / ms:.4f}" if ms is not None
                     else "share of bound incomplete")
            if twin:
                base = (f"; twin (the torch tail) {_ms_text(twin['twin_ms'])} "
                        f"device time (torch.profiler){base}")
            print(f"per batch {name} {suite}: "
                  f"{tm['launches_per_batch'].get(name, 0):.1f} launches per "
                  f"timed batch, {len(calls)} chunks replayed: kernel "
                  f"{_ms_text(ms)} device time, {n_bytes} bytes, bound "
                  f"{b:.4f} ms, {share} "
                  f"({occupancy_text(occ[name])}){base}")
    return out


def baseline_synthetic(name: str, kern, baselines: dict,
                       what: str = "synthetic", base_kern=None) -> dict:
    """ms of the call `kern` (the synthetic chunk's, or `what`) through
    each baseline build of kernel `name` that exists (`base_kern` in its
    place where an earlier build takes other calls)."""
    out = {}
    for tag, libs in baselines.items():
        if libs.get(name) is not None:
            with kernel_lib(name, libs[name]):
                out[tag] = _single_ms([base_kern or kern], 20)
            print(f"baseline {tag} {name} {what}: "
                  f"{_reading_text(out[tag])}")
    return out


def hard_cases_vs_twin() -> None:
    """Each synthetic hard case of `ops/kernel_cases.py` at kk = 1, 10 and
    128 through the group-probe, windowed-probe, deep-probe, per-segment
    phrase, packed flat-scorer or dense flat-scorer kernel (both forms) and
    its twin on the card, bitwise."""
    import torch

    from tantivy_tpu_torch.ops import kernel_cases as kc
    from tantivy_tpu_torch.ops.device_index import PackedMirror

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    cases = [("group", kind, None, kc.group_case(kind))
             for kind in kc.GROUP_KINDS]
    cases += [("bool", kind, kw, kc.bool_case(kind, kw))
              for kind, kw in (("every_row", 64), ("store_end", 8),
                               ("store_end", 64))]
    for kernel, kind, kw, case in cases:
        rows, cstore = dev(case["rows"]), dev(case["cstore"].view(np.int32))
        tables = tuple(dev(a) for a in case["tables"])
        for kk in (1, 10, 128):
            if kernel == "group":
                rec = dict(tables=tables, cstore=cstore, k=kk,
                           num_prows=case["num_prows"])
                calls = group_calls(rec, rows)
            else:
                rec = dict(tables=tables, cstore=cstore, k=kk, kw=kw,
                           num_queries=case["num_queries"])
                calls = bool_calls(rec, rows)
            name = f"{kernel}_probe hard case {kind}" + (
                f" kw={kw}" if kw else "") + f" kk={kk}"
            _, n_rep = _compare(name, *calls)
            print(f"kernel==twin {name}: W={rows.shape[0]} "
                  f"T={case['T']} reported={n_rep} bitwise equal")
    for kind in kc.DEEP_KINDS:
        case = kc.deep_case(kind)
        rec = dict(rows=dev(case["rows"]),
                   tables=tuple(dev(a) for a in case["tables"]),
                   cstore=dev(case["cstore"].view(np.int32)),
                   blk_last=dev(case["blk_last"].view(np.int32)),
                   num_queries=case["num_queries"], n_iters=case["n_iters"])
        for kk in (1, 10, 128):
            name = f"deep_probe hard case {kind} kk={kk}"
            _, n_rep = _compare(name, *deep_calls({**rec, "k": kk}))
            print(f"kernel==twin {name}: W={case['rows'].shape[0]} "
                  f"T={case['T']} n_iters={case['n_iters']} "
                  f"reported={n_rep} bitwise equal")
    for kind in kc.PHRASE_KINDS:
        case = kc.phrase_case(kind)
        rec = dict(rows=dev(case["rows"]),
                   tables=tuple(dev(a) for a in case["tables"]),
                   cstore=dev(case["cstore"].view(np.int32)),
                   postore=dev(case["postore"].view(np.int32)),
                   blk_pos=dev(case["blk_pos"].astype(np.int32)),
                   blk_last=dev(case["blk_last"].view(np.int32)),
                   num_queries=case["num_queries"], kw=case["kw"],
                   pw=case["pw"], n_iters=case["n_iters"])
        for kk in (1, 10, 128):
            name = f"seg_phrase hard case {kind} kk={kk}"
            _, n_rep = _compare(name, *seg_phrase_calls({**rec, "k": kk}))
            print(f"kernel==twin {name}: W={case['rows'].shape[0]} "
                  f"T={case['T']} kw={case['kw']} pw={case['pw']} "
                  f"reported={n_rep} bitwise equal")
    for kind in kc.PACKED_KINDS:
        case = kc.packed_case(kind)
        mirror = PackedMirror(*(
            dev(a.view(np.int32) if a.dtype == np.uint32 else a)
            for a in case["mirror"]))
        head = (mirror, dev(case["blocks"]), dev(case["qids"]),
                dev(case["weights"]), dev(case["caches"]))
        for kk in (1, 10, 128):
            name = f"packed_flat hard case {kind} kk={kk}"
            _, n_rep = _compare(name, *packed_flat_calls(
                (*head, kk, case["num_queries"])))
            print(f"kernel==twin {name}: W={len(case['blocks'])} "
                  f"reported={n_rep} bitwise equal")
    for kind in kc.DENSE_KINDS:
        case = kc.dense_case(kind)
        store = tuple(dev(case[key].view(np.int32)
                          if case[key].dtype == np.uint32 else case[key])
                      for key in ("cstore", "rows", "qids", "weights"))
        cache = tuple(None if case[key] is None else dev(
            case[key].view(np.int32) if case[key].dtype == np.uint32
            else case[key])
            for key in ("docs", "tfs", "valid", "qids", "norm_ids", "alive",
                        "weights", "caches"))
        Q = case["num_queries"]
        # k = 200 takes the row stage and the torch merge
        for k in (1, 10, 128, 200):
            name = f"dense_flat hard case {kind} k={k}"
            head = _compare(f"{name} store form", *dense_flat_calls(
                (*store, k, Q))) if k <= 128 else _compare(
                f"{name} store form", dense_rows_call((*store, k, Q)),
                dense_flat_calls((*store, k, Q))[1])
            _, n_cache = _compare(f"{name} cache form",
                                  *dense_cache_calls(cache, k, Q))
            print(f"kernel==twin {name}: W={len(case['rows'])} finite "
                  f"slots store form {head[1]}, cache form {n_cache}, "
                  "bitwise equal")


def _compare_packed(name, kernel, twin):
    """Run `kernel` and `twin` (no-argument calls returning a packed
    [2 or 3, Q, k] int32 result) once each; they must be equal word for
    word. Returns the largest score difference (0.0) and the number of
    finite slots."""
    import torch

    got, want = kernel(), twin()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} kernel words differ from the "
                             "twin")
    fin = torch.isfinite(want[0].view(torch.float32))
    return 0.0, int(fin.sum())


def merge_tail_vs_twin(groups: dict, baselines: dict) -> dict:
    """Phase 10: every merge-tail call of `groups` ({path: the tail
    records of its timed batches}) through K8 and its twin, bitwise; then
    each `kernel_cases.tail_case` at kk = 32 and 128, k = 1, 10, 40, 128,
    200, 1000 and 2000, in both forms. Returns the record of the kernels
    line: the largest call's kernel ms (`_single_ms`), twin ms (CUDA
    events), bound and ms through each baseline build of K8, the calls
    held per path and form, and K8's launches by kernel name."""
    import torch

    from tantivy_tpu_torch.ops import kernel_cases as kc
    from tantivy_tpu_torch.ops import merge_tail

    held, big = {}, None
    for path, recs in groups.items():
        if not recs:
            raise AssertionError(f"merge tails: the {path} path made no "
                                 "merge-tail call")
        for i, rec in enumerate(recs):
            kern, twin = merge_tail_calls(rec["args"])
            _compare_packed(f"merge_tail {path} call {i} ({rec['form']} "
                            "form)", kern, twin)
            key = f"{path} {rec['form']}"
            held[key] = held.get(key, 0) + 1
            n_bytes = merge_tail_bytes(rec["args"])
            if big is None or n_bytes > big[0]:
                big = (n_bytes, rec)
    n_bytes, rec = big
    kern, twin = merge_tail_calls(rec["args"])
    W, kk = rec["args"][0].shape
    ms, twin_ms = _single_ms([kern], 20), _time_ms(twin, 3)
    print(f"kernel==twin merge_tail: {sum(held.values())} calls of the "
          f"timed batches bitwise equal ({held}); largest call "
          f"({rec['form']} form, W={W}, kk={kk}, k={rec['args'][4]}): "
          f"kernel {_reading_text(ms)}, twin {twin_ms:.3f} ms, bound "
          f"{bound_ms(n_bytes):.4f} ms")
    base_ms = baseline_synthetic("merge_tail", kern, baselines,
                                 "largest call")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)).cuda()

    for kind in kc.TAIL_KINDS:
        for kk in (32, 128):
            case = kc.tail_case(kind, kk=kk)
            head = (dev(case["row_sc"]), dev(case["row_doc"]))
            qid, Q = dev(case["qid"]), case["num_queries"]
            for form in ("rows", "seg"):
                seg = dev(case["row_seg"]) if form == "seg" else None
                for k in (1, 10, 40, 128, 200, 1000, 2000):
                    name = (f"merge_tail hard case {kind} {form} form "
                            f"kk={kk} k={k}")
                    _, n_fin = _compare_packed(name, *merge_tail_calls(
                        (*head, seg, qid, k, Q)))
                    print(f"kernel==twin {name}: W={case['qid'].shape[0]} "
                          f"finite slots {n_fin}, bitwise equal")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": twin_ms,
            "bound_ms": bound_ms(n_bytes), "calls_held": held,
            "baseline_largest_ms": base_ms,
            "kernels_per_call": merge_tail.KERNELS_PER_CALL}


def group_probe_vs_twin(log, baselines: dict) -> dict:
    max_err = 0.0
    picks = pick_launches(
        log, "bool", lambda r: (r["n_clauses"], _phase2(r["tables"][5])),
        ((2, False), (2, True), (4, False), (4, True)),
    )
    for (t, p2), rec in picks:
        name = f"group_probe T{t}_{'p2' if p2 else 'p1'}"
        for ci, (rows, _, _) in enumerate(rec["chunks"]):
            err, n_rep = _compare(f"{name}[{ci}]", *group_calls(rec, rows))
            max_err = max(max_err, err)
            print(f"kernel==twin {name} chunk {ci}: W={rows.shape[0]} "
                  f"reported={n_rep} bitwise equal")
    rec, rows = synthetic_rows(log, "bool", SYNTH_W)
    kern, twin = group_calls(rec, rows)
    err, n_rep = _compare("group_probe synthetic", kern, twin)
    max_err = max(max_err, err)
    ms = _single_ms([kern], 20)
    plain_ms = _time_ms(twin, 3)
    bound = bound_ms(group_probe_bytes(rec, rows))
    print(f"kernel==twin group_probe synthetic: W={rows.shape[0]} "
          f"T={rec['n_clauses']} kk={min(rec['k'], 128)} reported={n_rep} "
          f"bitwise equal; kernel {_reading_text(ms)}, twin "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "baseline_synthetic_ms": baseline_synthetic("group_probe", kern,
                                                        baselines)}


def phrase_probe_vs_twin(log, baselines: dict) -> dict:
    from tantivy_tpu_torch.ops.fused_phrase import _PHRASE_RUNGS

    picks = pick_launches(
        log, "phrase", lambda r: (r["n_partners"], _phase2(r["row_th"])),
        ((1, False), (1, True), (3, False), (3, True)),
    )
    # both slab rungs: add the first round holding a chunk of a rung that
    # the picked rounds lack
    rungs = {c[0] for _, rec in picks for c in rec["chunks"]}
    for rr, _ in _PHRASE_RUNGS:
        if rr in rungs:
            continue
        rec = next((r for r in log if r["kind"] == "phrase"
                    and any(c[0] == rr for c in r["chunks"])), None)
        if rec is None:
            raise AssertionError(f"main path made no phrase launch with "
                                 f"{rr}-row slabs")
        picks.append(((rec["n_partners"], _phase2(rec["row_th"])), rec))
    max_err = 0.0
    for (S, p2), rec in picks:
        name = f"phrase_probe S{S}_{'p2' if p2 else 'p1'}"
        for ci, (rr, rows, _, _) in enumerate(rec["chunks"]):
            err, n_rep = _compare(f"{name}[{ci}]",
                                  *phrase_calls(rec, rr, rows))
            max_err = max(max_err, err)
            print(f"kernel==twin {name} chunk {ci}: W={rows.shape[0]} "
                  f"slab rows={rr} reported={n_rep} bitwise equal")
    rr = _PHRASE_RUNGS[0][0]
    rec, rows = synthetic_rows(log, "phrase", SYNTH_W_PHRASE, rr)
    kern, twin = phrase_calls(rec, rr, rows)
    err, n_rep = _compare("phrase_probe synthetic", kern, twin)
    max_err = max(max_err, err)
    ms = _single_ms([kern], 20)
    plain_ms = _time_ms(twin, 3)
    bound = bound_ms(phrase_probe_bytes(rec, rr, rows))
    print(f"kernel==twin phrase_probe synthetic: W={rows.shape[0]} "
          f"S={rec['n_partners']} slab rows={rr} kk={min(rec['k'], 128)} "
          f"reported={n_rep} bitwise equal; kernel {_reading_text(ms)}, twin "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "baseline_synthetic_ms": baseline_synthetic("phrase_probe", kern,
                                                        baselines)}


def bool_probe_vs_twin(log, baselines: dict) -> dict:
    chosen = {}
    for rec in log:
        if rec["kind"] == "probe":
            chosen.setdefault((rec["phase"], rec["n_clauses"], rec["kw"]),
                              rec)
    for need in ((1, 2), (2, 2), (1, 4), (2, 4)):
        if not any(key[:2] == need for key in chosen):
            raise AssertionError(f"probe path made no windowed launch with "
                                 f"(phase, T) = {need}")
    max_err = 0.0
    for (phase, t, kw), rec in sorted(chosen.items()):
        name = f"bool_probe p{phase} T{t} kw{kw}"
        err, n_rep = _compare(name, *bool_calls(rec, rec["rows"]))
        max_err = max(max_err, err)
        print(f"kernel==twin {name}: W={rec['rows'].shape[0]} "
              f"reported={n_rep} bitwise equal")
    times = []
    for W, kw, t in SYNTH_PROBE:
        # the largest real chunk of this rung and clause bucket, its real
        # items repeated to fill W
        rec = max((r for r in log if r["kind"] == "probe" and r["kw"] == kw
                   and r["n_clauses"] == t),
                  key=lambda r: r["rows"].shape[0], default=None)
        if rec is None:
            raise AssertionError(f"probe path made no launch with kw={kw}, "
                                 f"T={t}")
        live = rec["rows"][rec["rows"][:, 1] < rec["num_queries"]]
        rows = live.repeat(-(-W // live.shape[0]), 1)[:W].contiguous()
        kern, twin = bool_calls(rec, rows)
        err, n_rep = _compare(f"bool_probe synthetic kw{kw}", kern, twin)
        max_err = max(max_err, err)
        ms = _single_ms([kern], 20)
        plain_ms = _time_ms(twin, 3)
        bound = bound_ms(bool_probe_bytes(rec, rows))
        times.append((ms, plain_ms, bound,
                      baseline_synthetic("bool_probe", kern, baselines)))
        print(f"kernel==twin bool_probe synthetic: W={W} kw={kw} T={t} "
              f"kk={min(rec['k'], 128)} reported={n_rep} bitwise equal; "
              f"kernel {_reading_text(ms)}, twin {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms")
    return {"max_abs_err": max_err, "ms": times[0][0],
            "plain_ms": times[0][1], "bound_ms": times[0][2],
            "baseline_synthetic_ms": times[0][3]}


def same_details(name: str, got: list, want: list) -> None:
    """Two lists of per-call UB detail dicts (`batched_clause_details`'s)
    are equal: ids, the window columns, UB and term bits."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} calls, not {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        same = (np.array_equal(g["ids"], w["ids"])
                and np.array_equal(g["ub"].view(np.int32),
                                   w["ub"].view(np.int32))
                and all(np.array_equal(g[key], w[key])
                        for key in ("widths", "jlo", "i0", "i1"))
                and list(g["terms"]) == list(w["terms"])
                and all(np.array_equal(g["terms"][p].view(np.int32),
                                       w["terms"][p].view(np.int32))
                        for p in w["terms"]))
        if not same:
            raise AssertionError(f"{name}: call {i} differs from numpy")


def ub_sweep_bytes(store, pk, flat) -> int:
    """The least bytes a UB sweep moves: its outputs written (`flat`, the
    kernel's int32 outputs on the host), the packed tables read, and for
    each block the sweep touches its first and last doc (a block row's
    own) and `bfac` (a row's own, or in a range max's [i0, i1)) read
    once."""
    n_blk = len(store.bfac)
    P = pk.n_pairs
    own = _covered(n_blk, pk.starts, pk.starts + pk.ns)
    scanned = own | _covered(n_blk, flat[P:2 * P], flat[2 * P:3 * P])
    return (4 * flat.size + 4 * pk.tables.size + 8 * int(own.sum())
            + 4 * int(scanned.sum()))


def ub_sweep_vs_numpy(timing: dict) -> dict:
    """Every UB sweep of the main path's timed batches (recorded by
    `sweep_capture`), then all of them as one sweep, through the kernel and
    numpy's `batched_clause_details`, bitwise. For each suite's first sweep
    and the combined one, the kernel's device ms (`_single_ms`), the whole
    card path's and numpy's ms (host clock) and the bound. Returns the
    record of the largest sweep timed, with the combined one's inside."""
    import torch

    from tantivy_tpu_torch.ops import ub_sweep as us
    from tantivy_tpu_torch.parallel.wand import batched_clause_details

    def host_ms(fn, reps):
        spans = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(spans))

    def one(name, store, calls, timed: bool):
        got, n_pairs = us.clause_details(store, calls)
        want = batched_clause_details(store, calls)
        same_details(f"ub_sweep {name}", got, want)
        pk = us.Packed(calls)
        tables = torch.from_numpy(pk.tables).to(store.device)
        base, last, bfac = store.ub_tables()

        def kern():
            return us.sweep(base, last, bfac, tables, pk.n_calls, pk.n_rows,
                            pk.n_pairs)

        flat = kern().cpu().numpy()
        dropped = sum(c[1] - len(d["ids"]) for c, d in zip(calls, got))
        rec = {"calls": pk.n_calls, "rows": pk.n_rows, "pairs": n_pairs,
               "dropped": dropped,
               "bound_ms": bound_ms(ub_sweep_bytes(store, pk, flat))}
        times = ""
        if timed:
            rec.update(
                ms=_single_ms([kern], 5),
                sweep_ms=host_ms(lambda: us.clause_details(store, calls), 5),
                plain_ms=host_ms(
                    lambda: batched_clause_details(store, calls), 1))
            times = (f"kernel {_reading_text(rec['ms'])}, whole card path "
                     f"{rec['sweep_ms']:.2f} ms, numpy {rec['plain_ms']:.1f} "
                     f"ms (host clock), ")
        print(f"kernel==numpy ub_sweep {name}: {pk.n_calls} calls, "
              f"{pk.n_rows} block rows, {n_pairs} pair rows, {dropped} rows "
              f"dropped, bitwise equal; {times}bound {rec['bound_ms']:.4f} "
              "ms")
        return rec

    recs, swept = [], []
    for suite, tm in timing.items():
        for b, (store, calls) in enumerate(tm["sweeps"]):
            if any(c[1] for c in calls):
                recs.append(one(f"{suite} sweep {b}", store, calls, not b))
                swept.append((store, calls))
    if not recs:
        raise AssertionError("the main path made no UB sweep")
    stores = {id(store) for store, _ in swept}
    if len(stores) != 1:
        raise AssertionError(f"the main path's UB sweeps read {len(stores)} "
                             "stores")
    combined = one(f"all {len(swept)} sweeps as one", swept[0][0],
                   [c for _, calls in swept for c in calls], True)
    largest = max((r for r in recs if "ms" in r), key=lambda r: r["pairs"])
    return {"max_abs_err": 0.0, **largest, "combined": combined,
            "sweeps_compared": len(recs)}


def deep_probe_vs_twin(log, baselines: dict) -> dict:
    """Every deep chunk of the probe path (its warm and timed batches)
    through kernel K4 and its twin on the card, bitwise; the largest
    chunk's kernel ms (`_device_ms`), twin ms (CUDA events) and bound, and
    the ms of each baseline build of K4 on it."""
    recs = [r for r in log if r["kind"] == "deep"]
    if not recs:
        raise AssertionError("the probe path made no deep launch")
    max_err, n_rep = 0.0, 0
    for i, rec in enumerate(recs):
        err, n = _compare(f"deep_probe chunk {i}", *deep_calls(rec))
        max_err, n_rep = max(max_err, err), n_rep + n
    items = sum(int(r["rows"].shape[0]) for r in recs)
    print(f"kernel==twin deep_probe: {len(recs)} chunks of the probe path "
          f"({items} items, clause buckets "
          f"{sorted({r['n_clauses'] for r in recs})}, search depths "
          f"{sorted({r['n_iters'] for r in recs})}), reported={n_rep} "
          "bitwise equal")
    rec = max(recs, key=lambda r: r["rows"].shape[0])
    kern, twin = deep_calls(rec)
    ms = _single_ms([kern], 20)
    plain_ms = _time_ms(twin, 3)
    bound = bound_ms(deep_probe_bytes(rec, rec["rows"]))
    print(f"kernel==twin deep_probe largest chunk: W={rec['rows'].shape[0]} "
          f"T={rec['n_clauses']} kk={min(rec['k'], 128)} bitwise equal; "
          f"kernel {_reading_text(ms)}, twin {plain_ms:.3f} ms, bound "
          f"{bound:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "baseline_synthetic_ms": baseline_synthetic(
                "deep_probe", kern, baselines, "largest chunk")}


def seg_phrase_vs_twin(seg_timing, baselines: dict) -> dict:
    """Every K6 chunk of one timed batch of each per-segment phrase suite
    through the kernel and its twin on the card, bitwise; the largest
    chunk's kernel ms (`_device_ms`), twin ms (CUDA events) and bound, and
    the ms of each baseline build of K6 on it."""
    recs = [r for tm in seg_timing.values() for r in tm["batch_log"]
            if r["kind"] == "seg_phrase"]
    if not recs:
        raise AssertionError("the per-segment phrase path made no K6 launch")
    max_err, n_rep = 0.0, 0
    for i, rec in enumerate(recs):
        err, n = _compare(f"seg_phrase chunk {i}", *seg_phrase_calls(rec))
        max_err, n_rep = max(max_err, err), n_rep + n
    items = sum(int(r["rows"].shape[0]) for r in recs)
    print(f"kernel==twin seg_phrase: {len(recs)} chunks of one timed batch "
          f"per suite ({items} items, term counts "
          f"{sorted({r['n_terms'] for r in recs})}, (kw, pw) "
          f"{sorted({(r['kw'], r['pw']) for r in recs})}, phases "
          f"{sorted({r['phase'] for r in recs})}), reported={n_rep} "
          "bitwise equal")
    rec = max(recs, key=lambda r: r["rows"].shape[0])
    kern, twin = seg_phrase_calls(rec)
    ms = _single_ms([kern], 20)
    plain_ms = _time_ms(twin, 3)
    bound = bound_ms(seg_phrase_bytes(rec, rec["rows"]))
    print(f"kernel==twin seg_phrase largest chunk: W={rec['rows'].shape[0]} "
          f"T={rec['n_terms']} kw={rec['kw']} pw={rec['pw']} "
          f"kk={min(rec['k'], 128)} bitwise equal; kernel "
          f"{_reading_text(ms)}, twin {plain_ms:.3f} ms, bound "
          f"{bound:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "baseline_synthetic_ms": baseline_synthetic(
                "seg_phrase", kern, baselines, "largest chunk")}


def profile_layers(executor, seg_executor, packed_executor, stream,
                   seed: int, path: str) -> None:
    """Per-layer breakdown of one fresh batch per suite of the main path,
    of the segment route (`seg_executor.search_batch`, suites named
    `segment_*`) and of the probe path (`probe_*`), of the phrase log
    through the per-segment plan (`phrase_seg`) and of the term log
    through `search_term_batch` on the dense and the packed executor
    (`term_batch`, `packed_term_batch`): an untraced batch, then
    another with the engine's host spans (`tantivy_tpu_torch.utils.trace`) and
    `torch.profiler` on. Device time is the sum of the CUDA kernels' and
    copies' own time (overlap between streams would count twice); idle
    share is one minus device time over the traced wall time; the merge
    tails' kernel K8 and the sort kernels that remain are summed apart,
    and the main path's suites (the fused chains) may run no sort kernel.
    Writes the breakdown as JSON to `path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tantivy_tpu_torch.utils.trace import tracer

    out = {}
    logs = query_logs(stream, seed + 100, 2 * BATCH)
    runs = [(suite, executor, executor.search_batch, qlog)
            for suite, qlog in logs.items()]
    runs += [(f"segment_{suite}", seg_executor, seg_executor.search_batch,
              logs[suite]) for suite in SEGMENT_SUITES]
    runs += [(f"probe_{suite}", seg_executor,
              seg_executor.search_boolean_batch, qlog)
             for suite, qlog in probe_logs(logs).items()]
    runs.append(("phrase_seg", seg_executor, seg_executor.search_phrase_batch,
                 logs["phrase"]))

    def term_batch(ex):
        return lambda qs, k: ex.search_term_batch([q.term for q in qs], k)

    runs += [("term_batch", executor, term_batch(executor), logs["term"]),
             ("packed_term_batch", packed_executor,
              term_batch(packed_executor), logs["term"])]
    for suite, ex, search, qlog in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search(qlog[:BATCH], K)
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        tracer.clear()
        tracer.enable()
        before = sum(ex.fallbacks.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search(qlog[BATCH:], K)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tracer.disable()
        # device-side events only (kernels, copies): a CPU op's device time
        # is that of the kernels it launched, which are listed too
        device = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                device[ev.key] = (device.get(ev.key, 0.0)
                                  + ev.self_device_time_total / 1e3)
        if not device:
            raise AssertionError(f"profile {suite}: torch.profiler recorded "
                                 "no device time")
        busy = sum(device.values())
        sorts = {name: ms for name, ms in device.items()
                 if "sort" in name.lower()}
        if sorts and (suite == "term_batch" or suite in logs):
            raise AssertionError(f"profile {suite}: the batch at k={K} ran "
                                 f"sort kernels {sorts}")
        out[suite] = {
            "untraced_ms": untraced * 1e3,
            "traced_wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3),
            "host_plans": sum(ex.fallbacks.values()) - before,
            "merge_tail_ms": sum(ms for name, ms in device.items()
                                 if "merge_tail" in name),
            "sort_ms": sorts,
            "host_spans_ms": {k: v * 1e3 for k, v in
                              sorted(tracer.span_totals().items())},
            "device_ms": dict(sorted(device.items(), key=lambda kv: -kv[1])),
        }
        print(f"profile {suite}: untraced {untraced * 1e3:.1f} ms, traced "
              f"{wall * 1e3:.1f} ms, device busy {busy:.3f} ms (merge_tail "
              f"{out[suite]['merge_tail_ms']:.3f} ms, sorts "
              f"{sum(sorts.values()):.3f} ms {sorted(sorts)}), idle share "
              f"{out[suite]['idle_share']:.4f}, "
              f"{out[suite]['host_plans']} plans on the host engine")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"profile written to {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", metavar="PATH",
                    help="also write a per-layer breakdown (host spans, "
                         "device time, idle share) of one more batch per "
                         "suite to PATH as JSON")
    ap.add_argument("--baseline", metavar="NAME=DIR", action="append",
                    default=[],
                    help="also time every replayed chunk through the "
                         "kernels built from the sources in DIR (an "
                         "earlier commit's tantivy_tpu_torch/csrc)")
    args = ap.parse_args(argv)
    baseline_dirs = dict(spec.split("=", 1) for spec in args.baseline)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from tantivy_tpu_torch import BatchExecutor
    from tantivy_tpu_torch.ops import (
        _build,
        bool_probe,
        deep_probe,
        dense_flat,
        group_probe,
        merge_tail,
        packed_flat,
        phrase_probe,
        phrase_scorer,
        ub_sweep,
    )

    def zero_counts():
        group_probe.launches = 0
        phrase_probe.launches = 0
        bool_probe.launches = 0
        packed_flat.launches = 0
        deep_probe.launches = 0
        phrase_scorer.launches = 0
        dense_flat.reset_counts()
        merge_tail.reset_counts()
        ub_sweep.reset_counts()

    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"gpu: {gpu}")

    # one nvcc per kernel source, the baselines' too, all started together
    kernels = _build.KERNELS
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) * (1 + len(baseline_dirs))) as pool:
        futs = [pool.submit(_build.load, name) for name in kernels]
        base_futs = {tag: {name: pool.submit(build_kernel, name, src, tag)
                           for name in kernels}
                     for tag, src in baseline_dirs.items()}
        for fut in futs:
            fut.result()
        baselines = {tag: {name: fut.result() for name, fut in libs.items()}
                     for tag, libs in base_futs.items()}
    print(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc " + ", ".join(
              f"{name} {_build.build_seconds[name]:.1f} s" for name in kernels
          ) + ")" + "".join(f"; baseline {tag} from {baseline_dirs[tag]}"
                            for tag in baselines))
    for name in kernels:
        for line in _build.ptxas_report.get(name, "").splitlines():
            print(f"ptxas {name}: {line.strip()}")
    occ = {name: occupancy(_build.load(name), name) for name in kernels}
    for name in kernels:
        print(f"occupancy {name}: {occ[name]}")
        for tag, libs in baselines.items():
            lib = libs.get(name)
            if lib is not None and hasattr(lib, f"{name}_occupancy"):
                print(f"occupancy {name} baseline {tag}: "
                      f"{occupancy(lib, name)}")

    print(f"index codec: {zstd_codec()}")
    t0 = time.perf_counter()
    stream = token_stream(args.seed)
    index = build_index(stream, args.docs, args.seed)
    searcher = index.reader().searcher()
    n_seg = len(searcher.segment_readers())
    print(f"index: {args.docs} docs in {n_seg} segments, "
          f"{time.perf_counter() - t0:.1f} s")
    logs = query_logs(stream, args.seed, BATCH * (1 + TIMED_BATCHES))

    executor = BatchExecutor(searcher, device="cuda")
    executor.launch_log = []
    zero_counts()
    timing, answered = run_main_path(
        executor, logs, long_phrases(stream, args.seed), n_seg
    )
    launches = {"group_probe": group_probe.launches,
                "phrase_probe": phrase_probe.launches,
                "merge_tail": merge_tail.launches,
                "ub_sweep": ub_sweep.launches}
    main_tail_kernels = dict(merge_tail.launches_by_kernel)
    executor.launch_log, log = [], executor.launch_log
    main_tails = check_tail_launches("the main path", merge_tail.launches,
                                     log)
    fused = executor._fused()
    print(f"fused store: cstore {tuple(fused.cstore.shape)} and postore "
          f"{tuple(fused.postore.shape)} int32 on {fused.cstore.device} "
          f"({fused.num_pos} positions); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for suite, tm in timing.items():
        print(f"suite {suite}: {tm['qps']:.1f} QPS, p50 {tm['p50_ms']:.1f} ms"
              f" per {BATCH}-query batch, k={K} ({gpu}); "
              f"{tm['host_plans']} of {tm['plans']} (query, segment) plans "
              f"ran on the host engine {tm['host_by_reason']}")
    n_swept = {suite: sum(any(c[1] for c in calls)
                          for _, calls in tm["sweeps"])
               for suite, tm in timing.items()}
    print(f"launches on the main path: {launches} (merge_tail: "
          f"{main_tails} merge tails of the launch log, all of them K8; "
          f"ub_sweep: one a UB sweep with block rows, timed sweeps by suite "
          f"{n_swept}, plan_stats ub_sweep_card_rows "
          f"{executor.plan_stats.get('ub_sweep_card_rows', 0)}); "
          f"host_routed={executor.host_routed} "
          f"fallbacks={executor.fallbacks}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path launched no {name} kernel")
    if executor.host_routed:
        raise AssertionError(
            f"{executor.host_routed} queries were routed to the host engine"
        )
    executor.launch_log = None

    # 4b. the segment route: a second executor, fused=False, with its own
    # fused store
    seg = BatchExecutor(searcher, device="cuda", fused=False)
    seg.launch_log = []
    zero_counts()
    seg_route, seg_route_answered, prefix_s = run_segment_route(
        seg, logs, answered, n_seg)
    by_path = {"segment": launch_counts()}
    seg.launch_log = None
    for suite, tm in seg_route.items():
        fused_tm = timing[suite]
        print(f"segment suite {suite}: {tm['qps']:.1f} QPS, p50 "
              f"{tm['p50_ms']:.1f} ms per {BATCH}-query batch, k={K} ({gpu}), "
              f"against the main path's (fused route) {fused_tm['qps']:.1f} "
              f"QPS, p50 {fused_tm['p50_ms']:.1f} ms: "
              f"{tm['qps'] / fused_tm['qps']:.2f}x "
              f"its QPS; launches per timed batch "
              f"{tm['launches_per_batch']} (bool_probe by kw "
              f"{tm['k3_by_kw']}, {tm['flat_chunks']} flat chunks), the "
              f"planner's and launch log's counts; host_routed "
              f"{tm['host_routed']}; host plans by reason "
              f"{tm['host_by_reason']} of {tm['plans']} (query, segment) "
              f"plans; hits equal the main path's list for list")
    n_prefix = SEGMENT_PREFIX_QUERIES
    print(f"segment suite prefix: the first {n_prefix} queries of the prefix "
          f"log in one batch, no warm batch, all on the host engine, no "
          f"launch: {prefix_s:.2f} s, {prefix_s * 1e3 / n_prefix:.1f} ms per "
          f"query, against the main path's (fused route) "
          f"{timing['prefix']['p50_ms'] / BATCH:.1f} ms per query (p50 "
          f"batch / {BATCH}) ({gpu})")
    seg_store = seg._fused()
    print(f"launches on the segment route: {by_path['segment']}; "
          f"host_routed={seg.host_routed} fallbacks={seg.fallbacks}; its "
          f"fused store: cstore {tuple(seg_store.cstore.shape)}, postore "
          f"{tuple(seg_store.postore.shape)}; peak device memory with both "
          f"executors' stores {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held now")
    for name in ("dense_flat", "bool_probe", "deep_probe", "seg_phrase",
                 "merge_tail"):
        if by_path["segment"][name] == 0:
            raise AssertionError(f"the segment route launched no {name} "
                                 "kernel")

    # 5. the probe path on the fused=False executor, with its own counts
    # and peak memory
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats0 = dict(seg.plan_stats)
    seg.launch_log = []
    probe_timing, probe_answered = run_probe_path(seg, logs, n_seg)
    launches["bool_probe"] = bool_probe.launches
    launches["deep_probe"] = deep_probe.launches
    probe_tail_launches = merge_tail.launches
    probe_rungs = {kw: seg.plan_stats.get(f"probe_kw{kw}", 0)
                   - stats0.get(f"probe_kw{kw}", 0) for kw in PROBE_RUNGS}
    probe_deep = (seg.plan_stats.get("probe_deep", 0)
                  - stats0.get("probe_deep", 0))
    seg.launch_log, probe_log = None, seg.launch_log
    probe_tails = check_tail_launches("the probe path", probe_tail_launches,
                                      probe_log)
    for suite, tm in probe_timing.items():
        print(f"probe suite {suite}: {tm['qps']:.1f} QPS, p50 "
              f"{tm['p50_ms']:.1f} ms per {BATCH}-query batch, k={K} ({gpu}); "
              f"bool_probe launches by kw {tm['k3_by_kw']}, deep-path "
              f"launches {tm['deep']}; {tm['host_plans']} of {tm['plans']} "
              f"(query, segment) plans ran on the host engine")
    print(f"launches on the probe path: bool_probe {launches['bool_probe']} "
          f"(by kw {probe_rungs}), deep_probe {launches['deep_probe']} "
          f"(plan_stats probe_deep {probe_deep}), merge_tail "
          f"{probe_tail_launches} ({probe_tails} merge tails), group_probe "
          f"{group_probe.launches}, phrase_probe {phrase_probe.launches}; "
          f"peak device memory of the probe path "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("bool_probe", "deep_probe"):
        if launches[name] == 0:
            raise AssertionError(f"the probe path launched no {name} kernel")
    if launches["deep_probe"] != probe_deep:
        raise AssertionError(f"deep_probe launched {launches['deep_probe']} "
                             f"times, the planner counted {probe_deep} deep "
                             "chunks")
    if group_probe.launches or phrase_probe.launches:
        raise AssertionError("the probe path launched the fused chains' "
                             "kernels")

    # 5b. the per-segment phrase path on the fused=False executor, with its
    # own counts and peak memory
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats0 = dict(seg.plan_stats)
    seg.launch_log = []
    seg_timing, seg_answered = run_phrase_seg(
        seg, logs,
        long_phrases(stream, args.seed, BATCH * (1 + TIMED_BATCHES)), n_seg)
    seg_counts = launch_counts()
    launches["seg_phrase"] = seg_counts["seg_phrase"]
    seg_planned = (seg.plan_stats.get("phrase_seg", 0)
                   - stats0.get("phrase_seg", 0))
    seg.launch_log, seg_log = None, seg.launch_log
    seg_tails = check_tail_launches("the per-segment phrase path",
                                    seg_counts["merge_tail"], seg_log)
    main_phrase = timing["phrase"]
    for suite, tm in seg_timing.items():
        print(f"phrase_seg suite {suite}: {tm['qps']:.1f} QPS, p50 "
              f"{tm['p50_ms']:.1f} ms per {BATCH}-query batch, k={K} ({gpu}), "
              f"against the main path's phrase suite (K2) "
              f"{main_phrase['qps']:.1f} QPS, p50 {main_phrase['p50_ms']:.1f} "
              f"ms; seg_phrase launches {tm['k6_launches']} "
              f"({tm['launches_per_batch'].get('seg_phrase', 0):.1f} per "
              f"timed batch); {tm['host_plans']} of {tm['plans']} (query, "
              f"segment) plans ran on the host engine, by reason "
              f"{tm['host_by_reason']}")
    print(f"launches on the per-segment phrase path: {seg_counts} "
          f"(planner's phrase_seg launches {seg_planned}, {seg_tails} merge "
          f"tails); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["seg_phrase"] == 0:
        raise AssertionError("the per-segment phrase path launched no "
                             "seg_phrase kernel")
    if launches["seg_phrase"] != seg_planned:
        raise AssertionError(f"seg_phrase launched {launches['seg_phrase']} "
                             f"times, the planner counted {seg_planned}")
    others = {n: c for n, c in seg_counts.items()
              if c and n not in ("seg_phrase", "merge_tail")}
    if others:
        raise AssertionError(f"the per-segment phrase path launched {others}")
    if [bits(h) for _, h in seg_answered["phrase_seg"]] != [
            bits(h) for _, h in answered["phrase"]]:
        raise AssertionError("phrase_seg: hits differ from the main path's "
                             "phrase suite")
    print("phrase_seg: hits of the timed batches equal the main path's "
          "phrase suite list for list")
    # search_phrase_batch's route on the card, on each executor: the fused
    # chain (K2) on the fused route, the per-segment plan (K6) on the other,
    # each with its merge tails (K8)
    for ex, route, kernel in ((executor, "fused", "phrase_probe"),
                              (seg, "fused=False", "seg_phrase")):
        zero_counts()
        routed = ex.search_phrase_batch(logs["phrase"][BATCH:2 * BATCH], K)
        routed_counts = {n: c for n, c in launch_counts().items() if c}
        if sorted(routed_counts) != sorted([kernel, "merge_tail"]):
            raise AssertionError(f"search_phrase_batch on the {route} "
                                 f"executor launched {routed_counts} on the "
                                 f"card, not {kernel} and merge_tail alone")
        if [bits(h) for h in routed] != [
                bits(h) for _, h in answered["phrase"][:BATCH]]:
            raise AssertionError(f"search_phrase_batch on the {route} "
                                 "executor: hits differ from the main "
                                 "path's phrase suite")
        print(f"search_phrase_batch on the card, {route} executor: "
              f"{routed_counts} alone (with the merge tails), hits equal the "
              "main path's phrase suite")

    check_exact(searcher, {**answered, **seg_route_answered,
                           **probe_answered, **seg_answered}, args.seed)
    by_path.update({"main": {"group_probe": launches["group_probe"],
                             "phrase_probe": launches["phrase_probe"],
                             "merge_tail": launches["merge_tail"],
                             "ub_sweep": launches["ub_sweep"]},
                    "probe": {"bool_probe": launches["bool_probe"],
                              "deep_probe": launches["deep_probe"],
                              "merge_tail": probe_tail_launches},
                    "phrase_seg": {"seg_phrase": launches["seg_phrase"],
                                   "merge_tail": seg_counts["merge_tail"]}})

    def read_counts(path: str, needed) -> None:
        by_path[path] = launch_counts()
        for name in needed:
            if by_path[path][name] == 0:
                raise AssertionError(f"the {path} path launched no {name} "
                                     "kernel")

    # 6a. the main path again, pipelined
    zero_counts()
    pipelined = run_pipelined(executor, logs, answered)
    read_counts("pipelined", ("group_probe", "phrase_probe"))
    for suite, pm in pipelined.items():
        print(f"pipelined {suite}: {pm['qps']:.1f} QPS with "
              f"{min(PIPELINE, TIMED_BATCHES)} batches in flight "
              f"(pipeline={PIPELINE}) against {timing[suite]['qps']:.1f} closed "
              f"loop; p50 of batch_spans {pm['p50_ms']:.1f} ms against "
              f"{timing[suite]['p50_ms']:.1f} closed loop ({gpu}); results "
              "equal the closed-loop results")
    print(f"launches on the pipelined path: {by_path['pipelined']}")

    # 6b. term batches on the flat scorer: K7's store form
    term_batch = run_term_batches(executor, searcher, logs, args.seed,
                                  zero_counts)
    by_path["term_batch"] = term_batch["counts"]
    launches["dense_flat"] = by_path["term_batch"]["dense_flat"]
    print(f"term batch: {term_batch['qps']:.1f} QPS, p50 "
          f"{term_batch['p50_ms']:.1f} ms per {BATCH}-query batch, k={K} "
          f"({gpu}); dense_flat (K7) "
          f"{term_batch['launches_per_batch']:.1f} launches per timed batch "
          f"({term_batch['by_kernel']} in all), the launch log's flat chunks "
          f"times 2 kernels; flat scorer (K7 alone) "
          f"{_ms_text(term_batch['flat_ms'])} device time over the "
          f"{term_batch['flat_calls']} calls ({term_batch['flat_items']} work "
          f"items) of one batch, against "
          f"{_ms_text(term_batch['rows_route_ms'])} for the route of k > 128 "
          f"on the same calls (K7's row stage and "
          f"the torch merge tail); K7 replayed "
          f"{_ms_text(term_batch['k7_ms'])} "
          f"(torch.profiler; twin {term_batch['k7_twin_ms']:.3f} ms between "
          f"CUDA events), {term_batch['k7_bytes']} bytes, bound "
          f"{bound_ms(term_batch['k7_bytes']):.4f} ms; every K7 chunk equals "
          f"the twin bitwise; {term_batch['sampled']} sampled queries equal "
          f"to the host engine; launches {by_path['term_batch']}")

    # 6c. packed term batches: K5 over the bit-packed mirrors
    zero_counts()
    packed = run_packed_term_batches(searcher, logs, term_batch.pop("pairs"),
                                     args.seed)
    read_counts("packed_term_batch", ("packed_flat", "merge_tail"))
    launches["packed_flat"] = by_path["packed_term_batch"]["packed_flat"]
    packed_tails = check_tail_launches(
        "the packed term batches",
        by_path["packed_term_batch"]["merge_tail"], packed.pop("log"))
    packed.update(packed_flat_vs_twin(packed["batch_log"]))
    cstore_bytes = fused.cstore.numel() * fused.cstore.element_size()
    print(f"packed term batch: {packed['qps']:.1f} QPS, p50 "
          f"{packed['p50_ms']:.1f} ms per {BATCH}-query batch, k={K} ({gpu}) "
          f"against the dense term batch's {term_batch['qps']:.1f} QPS, p50 "
          f"{term_batch['p50_ms']:.1f} ms; packed_flat (K5) "
          f"{packed['launches_per_batch']:.1f} launches per timed batch, "
          f"{_ms_text(packed['ms'])} device time over the {packed['chunks']} "
          f"chunks ({packed['items']} work items) of one batch "
          f"(torch.profiler; twin {packed['twin_ms']:.3f} ms between CUDA "
          f"events), "
          f"{packed['bytes']} "
          f"bytes, bound {bound_ms(packed['bytes']):.4f} ms; every chunk "
          f"equals the twin bitwise; hits equal the dense term batches' and "
          f"{packed['sampled']} sampled queries the host engine; first warm "
          f"batch, the mirrors' upload included, {packed['warm_s']:.2f} s; "
          f"launches "
          f"{by_path['packed_term_batch']} (merge_tail: {packed_tails} merge "
          f"tails)")
    print(f"packed mirror: {packed['mirror_bytes']} bytes on the card for "
          f"`body` over {packed['segments']} segments, "
          f"{packed['mirror_bytes'] / packed['blocks']:.1f} B per 128-doc "
          f"block ({packed['blocks']} blocks), against the fused store's "
          f"cstore {cstore_bytes} bytes "
          f"({cstore_bytes / packed['blocks']:.1f} B per block; 1,536 B a "
          f"row): {cstore_bytes / packed['mirror_bytes']:.2f}x smaller")

    # 6d. sharded
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sharded = run_sharded(searcher, logs, answered)
    read_counts("sharded", ("group_probe", "phrase_probe"))
    for suite, sm in sharded["suites"].items():
        print(f"sharded {suite}: {sm['qps']:.1f} QPS, p50 "
              f"{sm['p50_ms']:.1f} ms over {len(SHARD_DEVICES)} shards on "
              f"{', '.join(SHARD_DEVICES)} ({gpu}); hits equal the single "
              "executor's")
    print(f"sharded: segments per shard {sharded['segments_per_shard']}, "
          f"set-up {sharded['setup_s']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the single "
          f"executor's store included); launches {by_path['sharded']}")

    # 6e. warmer, count and agg on the side index
    side = run_side_index(stream, logs, args.seed, zero_counts)
    by_path["warmer"] = {"group_probe": side["first_batch_group_probe"]}
    print(f"side index: {SIDE_DOCS} docs with fast fields in "
          f"{side['index_s']:.1f} s")
    print(f"warmer: DeviceSearchWarmer + reader {side['warm_ms']:.1f} ms; "
          f"for_searcher returned the warmed executor; its first batch "
          f"{side['first_batch_ms']:.1f} ms with "
          f"{side['first_batch_group_probe']} group_probe launches ({gpu})")
    print(f"count_batch: {BATCH} range queries in {side['count_ms']:.3f} ms "
          f"(host Count, one query at a time: {side['count_host_ms']:.1f} ms)"
          f"; all equal, {side['count_total']} docs counted")
    print(f"agg_batch: {len(AGG_REQUESTS)} requests in {side['agg_ms']:.1f} "
          f"ms (one AggregationCollector each: {side['agg_host_ms']:.1f} ms); "
          "all equal")

    # 6f. the entry points: the term scorer's forward on the card (K7's
    # cache form) and the sharded dry run
    entry_out = run_entry(zero_counts)
    by_path["entry"] = entry_out["counts"]
    print(f"entry: forward (term_scorer._topk_kernel, Q=8, B=4, k=10: K7's "
          f"group and select kernels) on "
          f"the card equals the CPU twin bitwise, {entry_out['finite']} "
          f"finite slots; kernel {_reading_text(entry_out['k7_ms'])}, "
          f"bound {entry_out['bound_ms']:.6f} ms; dryrun_multichip(4) passed "
          f"on {entry_out['dryrun']['devices']} ({gpu}); launches "
          f"{by_path['entry']}")

    big_w, big_ms, big_twin_ms, big_bytes = packed["big_chunk"]
    print(f"kernel==twin packed_flat largest chunk: W={big_w} bitwise "
          f"equal; kernel {_reading_text(big_ms)}, twin {big_twin_ms:.3f} "
          f"ms, bound {bound_ms(big_bytes):.4f} ms")
    d_w, d_ms, d_twin_ms, d_bytes, d_rows_ms = term_batch["big_chunk"]
    print(f"kernel==twin dense_flat largest chunk: W={d_w} bitwise equal; "
          f"kernel {_reading_text(d_ms)} (the route of k > 128: "
          f"{_reading_text(d_rows_ms)}), "
          f"twin {d_twin_ms:.3f} ms, bound {bound_ms(d_bytes):.4f} ms")
    stats = {"group_probe": group_probe_vs_twin(log, baselines),
             "phrase_probe": phrase_probe_vs_twin(log, baselines),
             "bool_probe": bool_probe_vs_twin(probe_log, baselines),
             "deep_probe": deep_probe_vs_twin(probe_log, baselines),
             "seg_phrase": seg_phrase_vs_twin(seg_timing, baselines),
             "packed_flat": {"max_abs_err": packed["max_abs_err"],
                             "ms": big_ms, "plain_ms": big_twin_ms,
                             "bound_ms": bound_ms(big_bytes),
                             "baseline_synthetic_ms": baseline_synthetic(
                                 "packed_flat", packed["big_call"],
                                 baselines, "largest chunk")},
             "dense_flat": {"max_abs_err": term_batch["max_abs_err"],
                            "ms": d_ms, "plain_ms": d_twin_ms,
                            "bound_ms": bound_ms(d_bytes),
                            "rows_route_ms": d_rows_ms,
                            "kernels_per_call": dense_flat.KERNELS_PER_CALL,
                            "cuda_kernels": {
                                "dense_flat_group_kernel":
                                    term_batch["by_kernel"].get("group", 0),
                                "dense_flat_select_kernel":
                                    term_batch["by_kernel"].get("select", 0),
                                "dense_flat_kernel (row stage, k > 128)":
                                    term_batch["by_kernel"].get("rows", 0)},
                            "baseline_synthetic_ms": baseline_synthetic(
                                "dense_flat", term_batch["big_call"],
                                baselines, "largest chunk",
                                term_batch["big_rows_call"])}}
    hard_cases_vs_twin()
    stats["ub_sweep"] = ub_sweep_vs_numpy(timing)
    per_batch = batch_kernel_times({
        **timing,
        **{f"probe_{suite}": tm for suite, tm in probe_timing.items()},
        **seg_timing,
        "packed_term": {"batch_log": packed["batch_log"],
                        "launches_per_batch": {
                            "packed_flat": packed["launches_per_batch"],
                            "merge_tail": len(packed["tails"])
                            * merge_tail.KERNELS_PER_CALL / TIMED_BATCHES}},
        "dense_term": {"batch_log": term_batch["batch_log"],
                       "launches_per_batch": {
                           "dense_flat": term_batch["launches_per_batch"]}},
    }, baselines, occ)
    print(f"library call: none for any kernel: {NO_LIBRARY}")
    if args.profile:
        profile_layers(executor, seg, packed["executor"], stream, args.seed,
                       args.profile)
    # 10. every merge tail of the timed batches through K8 and its twin
    stats["merge_tail"] = merge_tail_vs_twin({
        "fused route": [r for tm in timing.values() for r in tm["tails"]],
        "fused=False route": [
            r for tm in (*seg_route.values(), *probe_timing.values(),
                         *seg_timing.values()) for r in tm["tails"]],
        "packed executor": packed["tails"]}, baselines)
    stats["merge_tail"]["cuda_kernels"] = main_tail_kernels

    replaces = {"group_probe": "tantivy_tpu/ops/pallas_probe.py:533",
                "phrase_probe": "tantivy_tpu/ops/pallas_phrase.py:98",
                "bool_probe": "tantivy_tpu/ops/pallas_probe.py:126",
                "packed_flat": "tantivy_tpu/ops/decode.py:58 + "
                               "tantivy_tpu/ops/flat_scorer.py:43",
                "deep_probe": "tantivy_tpu/ops/probe_scorer.py:398",
                "seg_phrase": "tantivy_tpu/ops/phrase_scorer.py:71",
                "dense_flat": "tantivy_tpu/ops/term_scorer.py:25 + "
                              "tantivy_tpu/ops/flat_scorer.py:43",
                "merge_tail": "tantivy_tpu/ops/probe_scorer.py:120 + "
                              "tantivy_tpu/ops/probe_scorer.py:178",
                "ub_sweep": "no kernel: the host's numpy "
                            "batched_clause_details, "
                            "tantivy_tpu/parallel/wand.py:168"}
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"tantivy_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "launches_by_path": {path: counts.get(name, 0)
                             for path, counts in by_path.items()},
        **stats[name],
        "ms_sources": _sources(stats[name]),
        "occupancy": occ[name],
        "bound_by": "bytes",
        "library_ms": None,
        "per_batch": {suite: {key: _rounded(v) for key, v in rec.items()}
                      for suite, rec in per_batch.get(name, {}).items()},
    } for name in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
