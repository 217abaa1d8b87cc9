"""Runs one cell of the benchmark once and prints its result line.

    python3 searchbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json` at the checkout's
root; its configuration, traffic mix and per-layer metric readers are the
files of those names under `searchbench/`. The run needs the cards the
cell asks for: with none it exits non-zero and prints no result. The last
line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`, the numbers compared with the reference beside their limits);
the same checks are the last lines of standard error.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: string hashing fixed, so that the program's sets and dicts of strings
#: and bytes iterate in the same order in every run of a seed
HASH_SEED = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from searchbench.harness import Run

    return Run(args.workload, args.seed, args.seconds,
               bool(args.trace)).execute()


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.environ["PYTHONHASHSEED"] = HASH_SEED
        os.execv(sys.executable, [sys.executable] + sys.argv)
    sys.exit(main())
