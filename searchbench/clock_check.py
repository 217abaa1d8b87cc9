"""The error of the harness's marker alignment, checked against the clock
that the port's tracer shares with torch.profiler.

    python3 searchbench/clock_check.py --workload <cell> --seed <n> \\
        --seconds <s>

Runs the cell as `run.py --trace 1` does and prints its result line.
`Run.traced_batch` moves each batch's device events onto the host clock
by taking the end of a marker kernel, followed by a synchronise, as the
batch's start. kineto stamps the same events in Unix-epoch nanoseconds,
and the tracer maps `time.perf_counter()` onto that clock
(`Tracer.clock_us`), which gives each event's host time directly. The
last line of standard output is one JSON object: for each traced batch,
how much later the marker alignment puts the device events than the
shared clock does, in microseconds (`error_us`), its median and the
largest magnitude, and the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from searchbench.run import HASH_SEED  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch.profiler
    from torch.autograd import DeviceType

    from searchbench.harness import Run
    from tantivy_tpu_torch.utils.trace import tracer

    sessions = []

    class Session(torch.profiler.profile):
        def __enter__(self):
            sessions.append(self)
            return super().__enter__()

    torch.profiler.profile = Session
    errors = []

    class ClockRun(Run):
        def traced_batch(self, strings):
            hits, rec = super().traced_batch(strings)
            prof = sessions[-1]
            evs = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
            if evs:
                start_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
                # the marker's end on the shared clock, as perf_counter s
                end_s = (start_us + evs[0].time_range.end
                         - tracer.clock_us(0.0)) / 1e6
                errors.append((rec["t0"] - end_s) * 1e6)
            return hits, rec

    rc = ClockRun(args.workload, args.seed, args.seconds, True).execute()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": card(),
        "batches": len(errors), "error_us": errors,
        "median_us": statistics.median(errors) if errors else None,
        "largest_us": max(map(abs, errors)) if errors else None,
    }), flush=True)
    return rc


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.environ["PYTHONHASHSEED"] = HASH_SEED
        os.execv(sys.executable, [sys.executable] + sys.argv)
    sys.exit(main())
