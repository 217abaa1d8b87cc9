"""What the readers of the port's batch spans share. The program roots
each batch's spans in one `batch.search` span around
`BatchExecutor.search_batch`; where a trace holds none (a program that
records no such span), those readers find nothing to read."""

from __future__ import annotations

from searchbench import tracebook as tb

ROOT = "batch.search"


def recorded(trace: dict) -> bool:
    """Whether the program recorded its root span in the traced window."""
    return any(name == ROOT for b in trace["batches"]
               for name, _, _ in b["spans"])


def ms_per_batch(trace: dict, seconds) -> float | None:
    """`seconds(batch)` over the traced batches, in ms a batch; None
    where the program recorded no root span."""
    batches = trace["batches"]
    if not batches or not recorded(trace):
        return None
    return 1e3 * sum(seconds(b) for b in batches) / len(batches)


def covered(batch: dict, names) -> float:
    """Seconds under some span whose name starts with one of `names`."""
    return tb.length(tb.spans_named(batch, names))


def self_time(batch: dict, outer, inner) -> float:
    """Seconds under the spans named `outer` and under none named
    `inner` (names as prefixes)."""
    out = tb.union(tb.spans_named(batch, outer))
    return tb.length(out) - tb.length(
        tb.intersect(out, tb.spans_named(batch, inner)))
