"""The control of the check that decides `correct`: the reference in the
precision below the configuration's (bfloat16 for float32), put in the
program's place at a cell's own size, on the seeds given. Each seed's
line gives the numbers the check compares; every line has to read not
correct. The benchmark's own runs never run this.

    python3 searchbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--batches N]

`--batches` is how many of the window's batches count as answered (the
check samples among them, as a run does).
"""

import argparse
import json
import os
import sys
from collections import namedtuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from searchbench.corpus import make_corpus, text_fields  # noqa: E402
from searchbench.harness import Run  # noqa: E402
from searchbench.reference import Arith, Reference  # noqa: E402
from searchbench.traffic import Traffic  # noqa: E402

#: the address of a hit as the program gives it
Address = namedtuple("Address", "segment_ord doc_id")


def control_run(workload: str, seed: int, batches: int, precision: str,
                **where) -> dict:
    """The check of a run whose answers are the reference's in
    `precision`, with `batches` batches answered."""
    run = Run(workload, seed, 0.0, False, device="cpu", **where)
    cfg = run.cell.config
    run.corpus = make_corpus(cfg["corpus"], seed, text_fields(cfg))
    run.traffic = Traffic(run.cell.mix, run.corpus, seed)
    strings = [s for i in range(batches) for s in run.traffic.batch_at(i)]
    run.answers = [(s, []) for s in strings]
    run.failed = 0
    low = Reference(run.corpus, Arith(precision))
    for i in run.sample():
        q = strings[i]
        run.answers[i] = (q, [(np.int32(b).view(np.float32),
                               Address(seg, doc))
                              for b, seg, doc in low.topk(q, run.traffic.k)])
    return run.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=8)
    args = p.parse_args(argv)
    for seed in args.seeds:
        checks = control_run(args.workload, seed, args.batches, "bfloat16")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "bfloat16", "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
