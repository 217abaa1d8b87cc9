"""Where kernels K4 (`csrc/deep_probe.cu`) and K6 (`csrc/seg_phrase.cu`)
spend their time on the card.

    python3 scripts/kernel_stages.py [--docs N] [--seed S] [--baseline DIR]

Each kernel is built again from copies of its source that return after a
stage (`STAGES`: each copy ends at the comment that opens the next stage),
and every copy, the current kernel and, with `--baseline DIR`, the build
of an earlier tree's `tantivy_tpu_torch/csrc` are timed in turn, twice, on
the same real chunks: one batch of the smoke's bigram phrase log through
the per-segment phrase plan (K6) and one batch each of its AND, OR and 3-4
clause logs through `search_boolean_batch` (K4), on the smoke's corpus.
Prints per kernel and build the device ms of the batch's chunks and of its
largest chunk (torch.profiler, `chip_smoke._device_ms`), whether each
complete build's output equals the current kernel's, and each build's CTAs
per SM. A stage's cost is the difference between its copy and the one
before. Needs a CUDA device; the copies build into build/stages/.
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

#: per kernel, (stage, the source line its copy returns before, a value
#: the copy stores so that the compiler keeps the stage's work)
STAGES = {
    "seg_phrase": (
        ("row", "  // the first and last live lanes: their docs bound every "
                "live doc", "(float)s_live[0]"),
        ("search", "    // each term's range and how its lanes search it",
         "(float)s_lb[0][0]"),
        ("stage", "  // every term's (tf, first position) for the lane's "
                  "doc, in term order", "(float)sm.st.rows[0][kLanes]"),
        ("probe", "  // compact the lanes every term holds",
         "(float)(ok ? 1 : 0)"),
        ("positions", "  tantivy_port::write_group_topk(",
         "(float)n_sur"),
    ),
    "deep_probe": (
        ("row", "  // the first and last live lanes: their docs bound every "
                "probed doc", "(float)s_live[0]"),
        ("search", "    // each clause's range, and the ranges staged in "
                   "clause order", "(float)s_lb[0][0]"),
        ("stage", "  float score = 0.0f;", "(float)sm.last[0]"),
        ("probe", "  // the staged words are read: the tail may take their "
                  "place", "score"),
    ),
}


def stage_copy(name: str, stage: str, anchor: str, keep: str) -> str:
    """A directory holding the kernel sources, with `name`.cu returning
    just before `anchor`; returns its path."""
    out = os.path.join(ROOT, "build", "stages", f"{name}_{stage}")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(CSRC):
        shutil.copy(os.path.join(CSRC, f), out)
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    if src.count(anchor) != 1:
        raise ValueError(f"{name}.cu holds {src.count(anchor)} copies of "
                         f"the {stage} anchor {anchor!r}")
    stop = f"  if (lane == 0) osc[0] = {keep};\n  if (true) return;\n"
    with open(os.path.join(out, f"{name}.cu"), "w") as f:
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
    calls_of = {"seg_phrase": cs.seg_phrase_calls,
                "deep_probe": cs.deep_calls}

    # one nvcc per copy, all started together
    jobs = {}
    with ThreadPoolExecutor(16) as pool:
        for name, stages in STAGES.items():
            jobs[name] = {"current": pool.submit(_build.load, name)}
            if args.baseline:
                jobs[name]["baseline"] = pool.submit(
                    cs.build_kernel, name, args.baseline,
                    f"stages_base_{name}")
            for stage, anchor, keep in stages:
                jobs[name][f"to {stage}"] = pool.submit(
                    cs.build_kernel, name,
                    stage_copy(name, stage, anchor, keep),
                    f"stages_{name}_{stage}")
    for name in STAGES:
        libs = {tag: fut.result() for tag, fut in jobs[name].items()}
        calls = [calls_of[name](r)[0] for r in recs[name]]
        largest = max(recs[name], key=lambda r: r["rows"].shape[0])
        big = [calls_of[name](largest)[0]]
        wants = [call() for call in calls]
        print(f"{name}: {len(calls)} chunks, "
              f"{sum(int(r['rows'].shape[0]) for r in recs[name])} items, "
              f"largest W={largest['rows'].shape[0]}")
        for tag, lib in libs.items():
            occ = cs.occupancy_text(cs.occupancy(lib, name))
            print(f"{name} {tag}: {occ}")
        for turn in range(2):
            for tag, lib in libs.items():
                with cs.kernel_lib(name, lib):
                    line = (f"{name} turn {turn} {tag}: batch "
                            f"{cs._device_ms(calls, reps=5):.4f} ms, largest "
                            f"chunk {cs._device_ms(big, reps=10):.4f} ms")
                    if not tag.startswith("to "):
                        n_same = sum(cs._same(call(), want)
                                     for call, want in zip(calls, wants))
                        line += f", output equal on {n_same}/{len(calls)}"
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
