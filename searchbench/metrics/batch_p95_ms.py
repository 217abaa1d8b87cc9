"""Entry: the 95th percentile of the traced window's batch latencies,
host clock from before parsing to after the device synchronised, in ms
(the sample count goes beside it on standard error)."""

import statistics


def read(trace):
    walls = [(b["t1"] - b["t0"]) * 1e3 for b in trace["batches"]]
    if not walls:
        return None
    if len(walls) == 1:
        return walls[0]
    return statistics.quantiles(walls, n=20, method="inclusive")[18]


def note(trace):
    return f"over {len(trace['batches'])} batches"
