"""Where kernels K4 (`csrc/deep_probe.cu`), K6 (`csrc/seg_phrase.cu`) and
K7 (`csrc/dense_flat.cu`: its per-query group and select kernels, and its
row stage) spend their time on the card.

    python3 scripts/kernel_stages.py [--docs N] [--seed S] [--baseline DIR]

Each kernel is built again from copies of its source that stop after a
stage (`STAGES`: each copy stops at the comment that opens the next
stage), and every copy, the current kernel and, with `--baseline DIR`, the
build of an earlier tree's `tantivy_tpu_torch/csrc` are timed in turn,
twice, on the same real chunks: one batch of the smoke's bigram phrase log
through the per-segment phrase plan (K6), one batch each of its AND, OR
and 3-4 clause logs through `search_boolean_batch` (K4) and one batch of
its term log through `search_term_batch` (K7's store form at k = 10, and
its row stage at kk = 10 on the same chunks), on the smoke's corpus.
Prints per kernel and build the device ms of the batch's chunks and of its
largest chunk (torch.profiler, `chip_smoke._device_ms`; "incomplete" where
the profiler missed device events), whether each complete build's output
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
}


def stage_copy(kernel: str, src_name: str, stage: str, anchor: str,
               stop: str) -> str:
    """A directory holding the kernel sources, with `src_name`.cu holding
    `stop` just before `anchor`; returns its path."""
    out = os.path.join(ROOT, "build", "stages", f"{kernel}_{stage}")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(CSRC):
        shutil.copy(os.path.join(CSRC, f), out)
    with open(os.path.join(CSRC, f"{src_name}.cu")) as f:
        src = f.read()
    if src.count(anchor) != 1:
        raise ValueError(f"{src_name}.cu holds {src.count(anchor)} copies "
                         f"of the {stage} anchor {anchor!r}")
    with open(os.path.join(out, f"{src_name}.cu"), "w") as f:
        f.write(src.replace(anchor, stop + anchor))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier tree's tantivy_tpu_torch/csrc")
    args = ap.parse_args(argv)

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
    ex = BatchExecutor(searcher, device="cuda")
    ex.launch_log = []
    ex._search_phrase_seg(logs["phrase"][batch], cs.K)
    recs = {"seg_phrase": [r for r in ex.launch_log
                           if r["kind"] == "seg_phrase"]}
    ex.launch_log = []
    probe = cs.probe_logs(logs)
    for suite in ("and", "or", "multi"):
        ex.search_boolean_batch(probe[suite][batch], cs.K)
    recs["deep_probe"] = [r for r in ex.launch_log if r["kind"] == "deep"]
    ex.launch_log = []
    ex.search_term_batch([q.term for q in logs["term"][batch]], cs.K)
    recs["dense_flat"] = recs["dense_flat_rows"] = [
        r for r in ex.launch_log if r["kind"] == "flat"]
    calls_of = {"seg_phrase": lambda r: cs.seg_phrase_calls(r)[0],
                "deep_probe": lambda r: cs.deep_calls(r)[0],
                "dense_flat": lambda r: cs.dense_flat_calls(r["args"])[0],
                "dense_flat_rows": _rows_call}

    def width(rec) -> int:
        return int((rec["rows"] if "rows" in rec else rec["args"][1])
                   .shape[0])

    # one nvcc per copy, all started together
    jobs = {}
    with ThreadPoolExecutor(16) as pool:
        for name, (src_name, same_calls, stages) in STAGES.items():
            jobs[name] = {"current": pool.submit(_build.load, src_name)}
            if args.baseline and same_calls:
                jobs[name]["baseline"] = pool.submit(
                    cs.build_kernel, src_name, args.baseline,
                    f"stages_base_{name}")
            for stage, anchor, stop in stages:
                jobs[name][f"to {stage}"] = pool.submit(
                    cs.build_kernel, src_name,
                    stage_copy(name, src_name, stage, anchor, stop),
                    f"stages_{name}_{stage}")
    for name, (src_name, _, _) in STAGES.items():
        libs = {tag: fut.result() for tag, fut in jobs[name].items()}
        calls = [calls_of[name](r) for r in recs[name]]
        largest = max(recs[name], key=width)
        big = [calls_of[name](largest)]
        wants = [call() for call in calls]
        print(f"{name}: {len(calls)} chunks, "
              f"{sum(width(r) for r in recs[name])} items, "
              f"largest W={width(largest)}")
        for tag, lib in libs.items():
            occ = cs.occupancy_text(cs.occupancy(lib, src_name))
            print(f"{name} {tag}: {occ}")
        for turn in range(2):
            for tag, lib in libs.items():
                with cs.kernel_lib(src_name, lib):
                    line = (f"{name} turn {turn} {tag}: batch "
                            f"{cs._ms_text(cs._device_ms(calls, reps=5))}, "
                            f"largest chunk "
                            f"{cs._ms_text(cs._device_ms(big, reps=10))}")
                    if not tag.startswith("to "):
                        n_same = sum(cs._same(call(), want)
                                     for call, want in zip(calls, wants))
                        line += f", output equal on {n_same}/{len(calls)}"
                print(line, flush=True)
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
