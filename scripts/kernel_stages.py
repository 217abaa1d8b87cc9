"""Where kernels K4 (`csrc/deep_probe.cu`), K6 (`csrc/seg_phrase.cu`), K7
(`csrc/dense_flat.cu`: its per-query group and select kernels, and its
row stage) and K8 (`csrc/merge_tail.cu`, the merge tails) spend their
time on the card.

    python3 scripts/kernel_stages.py [--docs N] [--seed S] [--baseline DIR]
                                     [--only KERNEL ...]

Each kernel is built again from copies of its source that stop after a
stage (`STAGES`: each copy stops at the comment that opens the next
stage), and every copy, the current kernel and, with `--baseline DIR`, the
build of an earlier tree's `tantivy_tpu_torch/csrc` are timed in turn,
twice, on the same real chunks: one batch of the smoke's bigram phrase log
through the per-segment phrase plan (K6), one batch each of its AND, OR
and 3-4 clause logs through `search_boolean_batch` (K4) and one batch of
its term log through `search_term_batch` (K7's store form at k = 10, and
its row stage at kk = 10 on the same chunks), and the merge tails (K8) of
one batch each of the term, prefix and 3-4 clause logs through the fused
route's `search_batch` and of the OR log through the per-segment path
(`search_boolean_batch` of a `fused=False` executor), on the smoke's
corpus. A kernel with stages of an earlier design (`BASELINE_STAGES`)
also has those copies made of the `--baseline` source and timed beside.
K8 also has copies (`K8_VARIANTS`) timed beside on each batch, whose
output must equal the current K8's: two that take one of its two kernels
wherever they can, also timed call by call on the merge tails of the
term, prefix, 3-4 clause and OR batches (the crossover of its small and
grid kernels), and one that delays a warp a round after the round's
barrier.
Prints per kernel and build the device ms of the batch's chunks and of its
largest chunk (torch.profiler, `chip_smoke._device_ms`; "incomplete" where
the profiler missed device events; K8's batch from CUDA events around the
calls queued behind a spin kernel, `chip_smoke._queued_ms`), whether each complete build's output
equals the current kernel's, and each build's CTAs per SM. A stage's cost
is the difference between its copy and the one before. Needs a CUDA
device; the copies build into build/stages/.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the repo root's smoke script)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tantivy_tpu_torch", "csrc")

def _osc_stop(keep: str) -> str:
    """Stop text of K4's and K6's copies: store a value that keeps the
    stage's work, and return."""
    return f"  if (lane == 0) osc[0] = {keep};\n  if (true) return;\n"


#: per timed kernel: (its source, whether an earlier tree's build takes
#: the same calls, its stages: (stage, the source line its copy stops
#: before, the text inserted there))
STAGES = {
    "seg_phrase": ("seg_phrase", True, (
        ("row", "  // the first and last live lanes: their docs bound every "
                "live doc", _osc_stop("(float)s_live[0]")),
        ("search", "    // each term's range and how its lanes search it",
         _osc_stop("(float)s_lb[0][0]")),
        ("stage", "  // every term's (tf, first position) for the lane's "
                  "doc, in term order",
         _osc_stop("(float)sm.st.rows[0][kLanes]")),
        ("probe", "  // compact the lanes every term holds",
         _osc_stop("(float)(ok ? 1 : 0)")),
        ("positions", "  tantivy_port::write_group_topk(",
         _osc_stop("(float)n_sur")),
    )),
    "deep_probe": ("deep_probe", True, (
        ("row", "  // the first and last live lanes: their docs bound every "
                "probed doc", _osc_stop("(float)s_live[0]")),
        ("search", "    // each clause's range, and the ranges staged in "
                   "clause order", _osc_stop("(float)s_lb[0][0]")),
        ("stage", "  float score = 0.0f;", _osc_stop("(float)sm.last[0]")),
        ("probe", "  // the staged words are read: the tail may take their "
                  "place", _osc_stop("score")),
    )),
    # K7 per query: the group kernel alone (the select kernel leaves at
    # once), then the rows staged by TMA and read, no scoring or selection
    "dense_flat": ("dense_flat", False, (
        ("group", "  // the tile: its query and items", "  if (true) return;\n"),
        ("load", "    // the row's lanes: scores, keys and candidates",
         "    if (true) {\n      if ((d[0] ^ tf[1] ^ c[2]) == 0x9e3779b9u) "
         "a.s.done[0] = 0;\n      continue;\n    }\n"),
    )),
    # K7's row stage (the route of k > 128, K7's first design): the rows
    # loaded into registers, no scoring or selection
    "dense_flat_rows": ("dense_flat", True, (
        ("load", "  // stage 4: scores, then each item's top-kk, one warp "
                 "round per slot",
         "  {\n    uint32_t x = 0;\n    for (int h = 0; h < kItemsPerWarp; "
         "++h)\n      for (int i = 0; i < kLanesPerThread; ++i)\n        "
         "x ^= doc[h][i] ^ tfv[h][i] ^ __float_as_uint(norm[h][i]) ^ "
         "(live[h][i] ? 1u : 0u);\n    if (x == 0x9e3779b9u) "
         "a.out_scores[0] = 0.0f;\n  }\n  if (true) return;\n"),
    )),
    # K8: the group phases alone (the grid kernel returns after their last
    # grid barrier, the small kernel once it has staged its query's rows),
    # then every load and no selection (no candidate is offered, so the
    # cross-tile merge reads lists of padding), then the tiles' selection
    # without the cross-tile merge (a tile of a query of several neither
    # publishes its list nor merges)
    "merge_tail": ("merge_tail", True, (
        ("group", "  // 5. select:", "  if (true) return;\n"),
        ("loads", "      sel.offer(e, real, sh.cnt + slot);",
         "      if (real && e.x == 0x9e3779b9u && e.z == 0x2545f491u) "
         "sh.wsum[0].x = 1;\n      if (true) continue;\n"),
        ("tiles", "    // 6. publish the tile's list; the last tile of the "
                  "query merges them",
         "    tile = next;\n    if (true) continue;\n"),
    )),
}


#: stages of an earlier design of a kernel, applied to the `--baseline`
#: source when it holds their anchors: K8's earlier design (a group kernel
#: of one CTA, then one warp a 32-row tile merging 32 candidates at a
#: time, the last tile of a query merging the tile lists alone)
BASELINE_STAGES = {
    "merge_tail": (
        ("group", "  // the tile: its query and rows\n",
         "  if (true) return;\n"),
        ("tiles", "  if (nt > 1) {\n    // publish the tile's list",
         "  if (run.len < 0) a.out[0] = run.len;\n  if (true) return;\n"),
    ),
}

#: K8's suites: the merge tails of one timed batch each
K8_SUITES = ("term", "prefix", "multi", "probe_or")

#: copies of K8 timed beside the current K8 on each batch, their output
#: held against its (source edits: (text, its replacement)): "grid" takes
#: the grid kernel for every call and "small" the small kernel for every
#: call of at most 16,384 rows, also timed call by call (the crossover of
#: the two kernels, which the limits kSmallCands, kSmallRows and
#: kSmallScan lie below); "skew" delays one warp a round, a different one
#: each round, after the round's barrier, so that the other warps run
#: ahead into the next round (the round loop must give the same output)
K8_VARIANTS = {
    "skew": (("    __syncthreads();\n    sel.n += sh.cnt[slot];\n",
              "    __syncthreads();\n"
              "    if ((((int)threadIdx.x >> 5) + (int)(f0 / kRound)) % kWarps"
              " == 0) {\n      __nanosleep(2000);\n    }\n"
              "    sel.n += sh.cnt[slot];\n"),),
    "grid": (("constexpr int kSmallCands = 16384;",
              "constexpr int kSmallCands = -1;"),),
    "small": (("constexpr int kSmallCands = 16384;",
               "constexpr int kSmallCands = 1 << 30;"),
              ("constexpr int kSmallRows = 2048;",
               "constexpr int kSmallRows = 16384;"),
              ("constexpr long long kSmallScan = 1LL << 22;",
               "constexpr long long kSmallScan = 1LL << 62;")),
}


def stage_copy(kernel: str, src_name: str, stage: str, anchor: str,
               stop: str, src_dir: str = CSRC, tag: str = "") -> str:
    """A directory holding the kernel sources of `src_dir`, with
    `src_name`.cu holding `stop` just before each line that starts with
    `anchor`; returns its path."""
    out = os.path.join(ROOT, "build", "stages", f"{kernel}{tag}_{stage}")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), out)
    with open(os.path.join(src_dir, f"{src_name}.cu")) as f:
        src = f.read()
    if src.count(anchor) < 1:
        raise ValueError(f"{src_name}.cu holds no {stage} anchor "
                         f"{anchor!r}")
    with open(os.path.join(out, f"{src_name}.cu"), "w") as f:
        f.write(src.replace(anchor, stop + anchor))
    return out


def variant_copy(kernel: str, src_name: str, variant: str, edits) -> str:
    """A directory holding the current kernel sources, with `src_name`.cu
    edited by `edits` ((text, replacement), each text found once);
    returns its path."""
    out = os.path.join(ROOT, "build", "stages", f"{kernel}_v_{variant}")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(CSRC, f), out)
    with open(os.path.join(CSRC, f"{src_name}.cu")) as f:
        src = f.read()
    for text, new in edits:
        if src.count(text) != 1:
            raise ValueError(f"{src_name}.cu holds {text!r} "
                             f"{src.count(text)} times, not once")
        src = src.replace(text, new)
    with open(os.path.join(out, f"{src_name}.cu"), "w") as f:
        f.write(src)
    return out


def k8_crossover(libs: dict, suites: dict) -> None:
    """Times every merge tail of `suites` ({suite: tail records}) alone
    through the "grid" and "small" copies of K8 (`K8_VARIANTS`) and prints
    one line a call (its shape, the kernel the current limits give it,
    both ms) and the sums by candidates a call, over the calls both
    copies can take."""
    from tantivy_tpu_torch.ops import merge_tail

    def kernel_of(call) -> str:
        merge_tail.reset_counts()
        call()
        return next(iter(merge_tail.launches_by_kernel))

    buckets = {}
    for suite, recs in suites.items():
        for rec in recs:
            sc, _, seg, _, k, nq = rec["args"]
            W, kk = (int(x) for x in sc.shape)
            call = cs.merge_tail_calls(rec["args"])[0]
            now = kernel_of(call)
            ms = {}
            for tag in ("grid", "small"):
                with cs.kernel_lib("merge_tail", libs[f"variant {tag}"]):
                    ms[tag] = cs._queued_ms([call], reps=20)
                    if tag == "small":
                        small_fits = kernel_of(call) == "tail_small"
            print(f"merge_tail crossover {suite}: "
                  f"{'seg' if seg is not None else 'rows'} W={W} kk={kk} "
                  f"Q={nq} k={k} cands={W * kk} now={now} grid "
                  f"{cs._ms_text(ms['grid'])}, small "
                  f"{cs._ms_text(ms['small']) if small_fits else 'n/a'}",
                  flush=True)
            if not small_fits or None in ms.values():
                continue
            b = 1 << max(W * kk - 1, 1).bit_length()
            n, g, sm, wins = buckets.get(b, (0, 0.0, 0.0, 0))
            buckets[b] = (n + 1, g + ms["grid"], sm + ms["small"],
                          wins + (ms["small"] < ms["grid"]))
    for b in sorted(buckets):
        n, g, sm, wins = buckets[b]
        print(f"merge_tail crossover cands <= {b}: {n} calls, grid "
              f"{g:.4f} ms, small {sm:.4f} ms, small faster on {wins}")


def _holds(src_dir: str, src_name: str, stages) -> bool:
    path = os.path.join(src_dir, f"{src_name}.cu")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        src = f.read()
    return all(src.count(anchor) >= 1 for _, anchor, _ in stages)


def k8_tails(ex, search, queries) -> list:
    """The merge-tail calls (K8) that `search(queries, K)` of executor
    `ex` makes."""
    ex.launch_log = []
    search(queries, cs.K)
    return cs.tail_records(ex.launch_log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier tree's tantivy_tpu_torch/csrc")
    ap.add_argument("--only", action="append", choices=sorted(STAGES),
                    help="time only these kernels (default: all)")
    args = ap.parse_args(argv)
    names = args.only or list(STAGES)

    import torch

    if not torch.cuda.is_available():
        print("kernel_stages: CUDA is not available", file=sys.stderr)
        return 1
    from tantivy_tpu_torch import BatchExecutor
    from tantivy_tpu_torch.ops import _build

    print(f"gpu: {cs.gpu_line()}")
    cs.zstd_codec()
    stream = cs.token_stream(args.seed)
    searcher = cs.build_index(stream, args.docs, args.seed).reader() \
        .searcher()
    logs = cs.query_logs(stream, args.seed, 2 * cs.BATCH)
    batch = slice(cs.BATCH, 2 * cs.BATCH)
    probe = cs.probe_logs(logs)
    ex = BatchExecutor(searcher, device="cuda")
    ex.launch_log = []
    recs = {}
    if "seg_phrase" in names:
        ex._search_phrase_seg(logs["phrase"][batch], cs.K)
        recs["seg_phrase"] = {"batch": [r for r in ex.launch_log
                                        if r["kind"] == "seg_phrase"]}
    if "deep_probe" in names:
        ex.launch_log = []
        for suite in ("and", "or", "multi"):
            ex.search_boolean_batch(probe[suite][batch], cs.K)
        recs["deep_probe"] = {"batch": [r for r in ex.launch_log
                                        if r["kind"] == "deep"]}
    if "dense_flat" in names or "dense_flat_rows" in names:
        ex.launch_log = []
        ex.search_term_batch([q.term for q in logs["term"][batch]], cs.K)
        flat = [r for r in ex.launch_log if r["kind"] == "flat"]
        recs["dense_flat"] = recs["dense_flat_rows"] = {"batch": flat}
    if "merge_tail" in names:
        seg = BatchExecutor(searcher, device="cuda", fused=False)
        recs["merge_tail"] = {
            "term": k8_tails(ex, ex.search_batch, logs["term"][batch]),
            "prefix": k8_tails(ex, ex.search_batch,
                                   logs["prefix"][batch]),
            "multi": k8_tails(ex, ex.search_batch, logs["multi"][batch]),
            "probe_or": k8_tails(seg, seg.search_boolean_batch,
                                     probe["or"][batch])}
    calls_of = {"seg_phrase": lambda r: cs.seg_phrase_calls(r)[0],
                "deep_probe": lambda r: cs.deep_calls(r)[0],
                "dense_flat": lambda r: cs.dense_flat_calls(r["args"])[0],
                "dense_flat_rows": _rows_call,
                "merge_tail": lambda r: cs.merge_tail_calls(r["args"])[0]}

    def width(name, rec) -> int:
        if name == "merge_tail":
            return int(rec["args"][0].shape[0])
        return int((rec["rows"] if "rows" in rec else rec["args"][1])
                   .shape[0])

    def same(name, a, b) -> bool:
        return torch.equal(a, b) if name == "merge_tail" else cs._same(a, b)

    # one nvcc per copy, all started together
    jobs = {}
    with ThreadPoolExecutor(16) as pool:
        for name in names:
            src_name, same_calls, stages = STAGES[name]
            jobs[name] = {"current": pool.submit(_build.load, src_name)}
            for stage, anchor, stop in stages:
                jobs[name][f"to {stage}"] = pool.submit(
                    cs.build_kernel, src_name,
                    stage_copy(name, src_name, stage, anchor, stop),
                    f"stages_{name}_{stage}")
            if name == "merge_tail":
                for variant, edits in K8_VARIANTS.items():
                    jobs[name][f"variant {variant}"] = pool.submit(
                        cs.build_kernel, src_name,
                        variant_copy(name, src_name, variant, edits),
                        f"stages_{name}_v_{variant}")
            if args.baseline and same_calls:
                jobs[name]["baseline"] = pool.submit(
                    cs.build_kernel, src_name, args.baseline,
                    f"stages_base_{name}")
                base_stages = BASELINE_STAGES.get(name, ())
                if _holds(args.baseline, src_name, base_stages):
                    for stage, anchor, stop in base_stages:
                        jobs[name][f"baseline to {stage}"] = pool.submit(
                            cs.build_kernel, src_name,
                            stage_copy(name, src_name, stage, anchor, stop,
                                       args.baseline, "_base"),
                            f"stages_base_{name}_{stage}")
    for name in names:
        src_name = STAGES[name][0]
        libs = {tag: fut.result() for tag, fut in jobs[name].items()}
        for tag, lib in libs.items():
            if tag.startswith("variant"):
                continue  # a variant lacks one kernel's occupancy query
            occ = cs.occupancy_text(cs.occupancy(lib, src_name))
            print(f"{name} {tag}: {occ}")
        for suite, suite_recs in recs[name].items():
            head = name if suite == "batch" else f"{name} {suite}"
            calls = [calls_of[name](r) for r in suite_recs]
            largest = max(suite_recs, key=lambda r: width(name, r))
            big = [calls_of[name](largest)]
            wants = [call() for call in calls]
            print(f"{head}: {len(calls)} chunks, "
                  f"{sum(width(name, r) for r in suite_recs)} items, "
                  f"largest W={width(name, largest)}")
            for turn in range(2):
                for tag, lib in libs.items():
                    with cs.kernel_lib(src_name, lib):
                        ms = (cs._queued_ms(calls) if name == "merge_tail"
                              else cs._device_ms(calls, reps=5))
                        line = (f"{head} turn {turn} {tag}: batch "
                                f"{cs._ms_text(ms)}, largest chunk "
                                f"{cs._ms_text(cs._device_ms(big, reps=10))}")
                        if "to " not in tag:
                            n_same = sum(same(name, call(), want)
                                         for call, want in zip(calls, wants))
                            line += (f", output equal on "
                                     f"{n_same}/{len(calls)}")
                    print(line, flush=True)
        if name == "merge_tail":
            k8_crossover(libs, recs[name])
    return 0


def _rows_call(rec):
    """K7's row stage alone on one logged flat chunk, at kk = min(k,
    128)."""
    from tantivy_tpu_torch.ops.dense_flat import dense_flat_rows_store

    cstore, rows, qids, weights, k = rec["args"][:5]
    return lambda: dense_flat_rows_store(cstore, rows, qids, weights,
                                         kk=min(k, 128))


if __name__ == "__main__":
    sys.exit(main())
